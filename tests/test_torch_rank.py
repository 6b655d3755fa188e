"""Learning to rank in the port against the JAX package, on the CPU.

Data: 60 queries of 5-40 documents (1,270 rows), 6 features, labels 0-4
from a relevance signal; 15 leaves (7 through the wave learner, whose
CPU runs are the slow ones), 3 rounds.

Contracts (tolerances stated where the frameworks' float32 `exp`, `log2`
and sums round apart):

* the query layout (buckets, rows, labels, masks) equal, and each query's
  1/maxDCG bit-equal (float64 on the host, then float32);
* lambdarank's lambdas and hessians bucket by bucket on the same inputs,
  against the JAX bucket function run op by op: |d| <= GRAD_ATOL (1e-6),
  with and without normalization, truncated at 3, on the port's and the
  JAX package's layouts; the whole objective over 3 iterations with
  weights and position debias: gradients within GRAD_ATOL_ITER (2e-5;
  the position biases, Newton-updated from each iteration's sums, drift
  by up to 3e-7 between the packages: the port sums a position's
  gradients exactly in fixed point, the JAX package in float32) and the
  biases within BIAS_ATOL (1e-6);
* rank_xendcg: the uniforms bit-equal to ``jax.random.uniform`` as the JAX
  objective draws them (jitted, under ``jax_threefry_partitionable``) at
  L in {8, 16, 256} over 3 iterations, the seeds equal; the gradients of
  3 iterations within XE_RTOL / XE_ATOL (1e-5 / 1e-7) of the JAX
  objective's;
* NDCG@k and MAP@k (eval_at 1, 3, 5, 10), with and without query weights:
  within 1e-6 of the JAX metrics;
* training: lambdarank through the serial and the wave learner, and
  rank_xendcg through the serial one, split for split (features,
  thresholds, decision types, counts equal; values within rtol 1e-5 /
  atol 1e-6, gains rtol 1e-4); grid-snapped lambdarank gradients through
  `fobj` (the port's objective on the host, snapped to 2**-8): model text
  byte-equal through the serial learner (the JAX split search op by op)
  and through the wave learner (split_gain within 4 ULP, ROADMAP Queue 3),
  the valid NDCG recorded within 1e-6;
* the async pipeline with position-debiased lambdarank (a learning rate
  exact in float32) bit-identical to the synchronous path;
* a checkpoint resume of rank_xendcg and of position-debiased lambdarank
  byte-equal to the uninterrupted run (the objective's state rides in the
  sidecar); the JAX package's resume is not (its sidecar has no objective
  state: ROADMAP Queue 3, fault 7);
* `cv` on a ranking Dataset does what the JAX package's does: its folds
  are row subsets without query structure, so the objective refuses them,
  and a splitter given `groups=` gets the query sizes (ROADMAP Queue 3);
* Dataset.set_group / set_position / create_valid(group=, position=) reach
  the metadata as in the JAX package.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.checkpoint import checkpoint_callback, load_checkpoint
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metrics import create_metric
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.objectives.rank import lambdarank_lambdas, xendcg_uniforms
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
from tests.test_torch_multiclass import _assert_text_equal_but_gain
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.torch_rank_data import SnappedLambdarank, rank_data, shown_positions
from tests.test_torch_train import _assert_split_for_split

CPU = torch.device("cpu")
GRAD_ATOL = 1e-6
GRAD_ATOL_ITER = 2e-5
BIAS_ATOL = 1e-6
XE_RTOL, XE_ATOL = 1e-5, 1e-7
METRIC_ATOL = 1e-6
WAVE_LEAVES = 7


def _metadata(y, sizes, weight=None, position=None):
    from lightgbm_tpu.io.metadata import Metadata as JaxMetadata

    md, jmd = Metadata(len(y)), JaxMetadata(len(y))
    for m in (md, jmd):
        m.set_label(y)
        m.set_query(sizes)
        if weight is not None:
            m.set_weights(weight)
        if position is not None:
            m.set_positions(position)
    return md, jmd


def _objectives(name, params, md, jmd):
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective

    cfg = {"objective": name, **params}
    obj = create_objective(name, Config(cfg))
    ref = jax_objective(name, JaxConfig(cfg))
    obj.init(md, md.num_data, CPU)
    ref.init(jmd, jmd.num_data)
    return obj, ref


def test_query_layout_matches_jax(jax_ref):
    _, y, sizes = rank_data()
    obj, ref = _objectives("lambdarank", {}, *_metadata(y, sizes))
    assert len(obj.layout.buckets) == len(ref.layout.buckets) > 1
    for b, r in zip(obj.layout.buckets, ref.layout.buckets):
        assert b["L"] == r["L"]
        np.testing.assert_array_equal(b["qids"], r["qids"])
        np.testing.assert_array_equal(b["doc_idx"].numpy(), np.asarray(r["doc_idx"]))
        np.testing.assert_array_equal(b["labels"].numpy(), np.asarray(r["labels"]))
        np.testing.assert_array_equal(b["valid"].numpy(), np.asarray(r["valid"]))
        np.testing.assert_array_equal(b["inv_max_dcg"].numpy(), np.asarray(r["inv_max_dcg"]))


LAMBDA_CASES = {"norm": {}, "no_norm": {"lambdarank_norm": False},
                "truncated": {"lambdarank_truncation_level": 3}}


@pytest.mark.parametrize("case", list(LAMBDA_CASES))
def test_lambdarank_bucket_lambdas_match_jax(jax_ref, case):
    """Each bucket's [Q, L] lambdas and hessians from the same scores: the
    port's `lambdarank_lambdas` against the JAX bucket function op by op."""
    import jax
    import jax.numpy as jnp

    _, y, sizes = rank_data()
    obj, ref = _objectives("lambdarank", LAMBDA_CASES[case], *_metadata(y, sizes))
    rng = np.random.RandomState(1)
    score = (rng.normal(size=len(y)) * 2).astype(np.float32)
    score_ext = np.append(score, np.float32(0))
    for b, r in zip(obj.layout.buckets, ref.layout.buckets):
        lam, hes = lambdarank_lambdas(torch.from_numpy(score_ext)[b["doc_idx"]], b["labels"],
                                      b["valid"], b["inv_max_dcg"], obj._gains, obj.sigmoid,
                                      obj.truncation_level, obj.norm)
        with jax.disable_jit():
            rlam, rhes = ref._bucket_fn(r["L"])(jnp.asarray(score_ext), r["doc_idx"],
                                                r["labels"], r["valid"], r["inv_max_dcg"])
        assert lam.dtype == hes.dtype == torch.float32
        np.testing.assert_allclose(lam.numpy(), np.asarray(rlam), rtol=0, atol=GRAD_ATOL)
        np.testing.assert_allclose(hes.numpy(), np.asarray(rhes), rtol=0, atol=GRAD_ATOL)
        # where the JAX value is 0 (pads, truncated-away documents), so is the port's
        np.testing.assert_array_equal(lam.numpy() == 0, np.asarray(rlam) == 0)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("position", [False, True], ids=["plain", "debiased"])
def test_lambdarank_gradients_match_jax(jax_ref, weighted, position):
    """The whole objective over 3 iterations, scores moving by the
    gradients, the position biases Newton-updated each call."""
    import jax
    import jax.numpy as jnp

    _, y, sizes = rank_data()
    rng = np.random.RandomState(2)
    weight = rng.uniform(0.5, 2.0, size=len(y)) if weighted else None
    pos = shown_positions(sizes) if position else None
    params = {"lambdarank_position_bias_regularization": 0.1} if position else {}
    obj, ref = _objectives("lambdarank", params, *_metadata(y, sizes, weight, pos))
    score = (rng.normal(size=len(y)) * 2).astype(np.float32)
    for _ in range(3):
        grad, hess = obj.get_gradients(torch.from_numpy(score))
        with jax.disable_jit():
            rgrad, rhess = ref.get_gradients(jnp.asarray(score))
        np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=0, atol=GRAD_ATOL_ITER)
        np.testing.assert_allclose(hess.numpy(), np.asarray(rhess), rtol=0, atol=GRAD_ATOL_ITER)
        if position:
            np.testing.assert_allclose(obj._pos_biases.numpy(), np.asarray(ref._pos_biases),
                                       rtol=0, atol=BIAS_ATOL)
            assert float(obj._pos_biases.abs().max()) > 0
        score = score - 0.5 * grad.numpy()


def _jax_uniforms(seeds, L):
    """The draw of the JAX objective's per_query (objectives/rank.py:263-265),
    jitted over the queries as the objective runs it."""
    import jax
    import jax.numpy as jnp

    def draw(seed):
        key = jax.random.PRNGKey(seed.astype(jnp.uint32))
        return jax.random.uniform(key, (L,), minval=1e-6, maxval=1.0)

    return np.asarray(jax.jit(jax.vmap(draw))(jnp.asarray(seeds, dtype=jnp.int32)))


@pytest.mark.parametrize("L", [8, 16, 256])
def test_xendcg_uniforms_bit_equal(jax_ref, L):
    _, y, sizes = rank_data()
    obj, ref = _objectives("rank_xendcg", {"objective_seed": 7}, *_metadata(y, sizes))
    qids = np.arange(40, dtype=np.int64)
    for it in range(1, 4):
        obj._iter = it
        seeds = obj.seeds(qids)
        want = (qids * 9973 + it * 31 + 7) % (2 ** 31)
        np.testing.assert_array_equal(seeds, want)
        got = xendcg_uniforms(seeds, L, CPU).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), _jax_uniforms(seeds, L).view(np.uint32))
        assert got.min() >= np.float32(1e-6) and got.max() < 1.0


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_xendcg_gradients_match_jax(jax_ref, weighted):
    import jax.numpy as jnp

    _, y, sizes = rank_data()
    rng = np.random.RandomState(3)
    weight = rng.uniform(0.5, 2.0, size=len(y)) if weighted else None
    obj, ref = _objectives("rank_xendcg", {}, *_metadata(y, sizes, weight))
    score = (rng.normal(size=len(y)) * 2).astype(np.float32)
    for it in range(3):
        grad, hess = obj.get_gradients(torch.from_numpy(score))
        rgrad, rhess = ref.get_gradients(jnp.asarray(score))
        assert obj._iter == ref._iter == it + 1
        np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=XE_RTOL, atol=XE_ATOL)
        np.testing.assert_allclose(hess.numpy(), np.asarray(rhess), rtol=XE_RTOL, atol=XE_ATOL)
        score = score - grad.numpy()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_rank_metrics_match_jax(jax_ref, name, weighted):
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.metrics import create_metric as jax_metric

    _, y, sizes = rank_data(seed=4)
    rng = np.random.RandomState(4)
    weight = rng.uniform(0.5, 2.0, size=len(y)) if weighted else None
    md, jmd = _metadata(y, sizes, weight)
    cfg = {"metric": name, "eval_at": [1, 3, 5, 10]}
    metric, ref = create_metric(name, Config(cfg)), jax_metric(name, JaxConfig(cfg))
    metric.init(md, len(y), CPU)
    ref.init(jmd, len(y))
    # integer scores: ties inside queries, broken by row order in both
    score = rng.randint(-3, 4, size=len(y)).astype(np.float32)
    got = metric.eval(torch.from_numpy(score), None)
    want = ref.eval(jnp.asarray(score), None)
    assert metric.name == ref.name == [f"{name}@{k}" for k in (1, 3, 5, 10)]
    assert metric.greater_is_better and ref.greater_is_better
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ATOL)


def test_query_without_relevant_document_counts_one():
    y = np.array([0, 0, 0, 2, 1, 0], dtype=np.float64)
    md = Metadata(6)
    md.set_label(y)
    md.set_query([3, 3])
    for name in ("ndcg", "map"):
        metric = create_metric(name, Config({"eval_at": [2]}))
        metric.init(md, 6, CPU)
        best = metric.eval(torch.tensor([3.0, 2.0, 1.0, 3.0, 2.0, 1.0]), None)
        worst = metric.eval(torch.tensor([3.0, 2.0, 1.0, 1.0, 2.0, 3.0]), None)
        assert best == [pytest.approx(1.0, abs=1e-6)]
        assert worst[0] < 1.0 and worst[0] > 0.5  # the first query still counts 1


RANK_PARAMS = {"num_leaves": 15, "min_data_in_leaf": 10, "verbosity": -1,
               "device_type": "cpu", "metric": "ndcg", "eval_at": [1, 3, 5]}


def _datasets(pkg, X, y, sizes, position=None):
    ds = pkg.Dataset(X, label=y, group=sizes, position=position)
    return ds, ds.create_valid(X, label=y, group=sizes)


def _train_both(jax_ref, monkeypatch, params, learner, rounds=3, fobj=None, position=None):
    """Each package's Booster trained `rounds` iterations with its serial
    learner or its wave learner (swapped into its GBDT; the JAX pipeline
    and both adaptive widths off), and the valid NDCG it recorded."""
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JaxLearner

    monkeypatch.setenv("LGBM_TPU_ADAPTIVE_WAVE", "0")
    monkeypatch.setenv("LGBM_TPU_ASYNC", "0")
    if learner == "wave":
        params = {**params, "num_leaves": WAVE_LEAVES}
    X, y, sizes = rank_data()
    out = []
    for pkg in (lt, jax_ref):
        train, valid = _datasets(pkg, X, y, sizes, position)
        bst = pkg.Booster(params=dict(params), train_set=train)
        bst.add_valid(valid, "valid")
        if learner == "wave":
            gbdt = bst._gbdt
            if pkg is lt:
                gbdt.tree_learner = DeviceTreeLearner(gbdt.config, train._handle, CPU)
                gbdt.tree_learner._adaptive_wave = False
            else:
                gbdt.tree_learner = JaxLearner(gbdt.config, train._handle)
        evals = []
        for _ in range(rounds):
            bst.update(fobj=fobj)
            evals.append([v for _, _, v, _ in bst.eval_valid()])
        out.append((bst, np.array(evals)))
    return out


@pytest.mark.parametrize("objective,learner", [("lambdarank", "serial"), ("lambdarank", "wave"),
                                               ("rank_xendcg", "serial")])
def test_ranking_training_split_for_split(jax_ref, monkeypatch, objective, learner):
    (port, port_evals), (ref, ref_evals) = _train_both(
        jax_ref, monkeypatch, {**RANK_PARAMS, "objective": objective}, learner)
    assert port.num_trees() == ref.num_trees() == 3
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    np.testing.assert_allclose(port_evals, ref_evals, rtol=0, atol=1e-5)
    assert port_evals[-1, -1] > port_evals[0, -1]


@pytest.mark.parametrize("learner", ["serial", "wave"])
def test_snapped_lambdarank_model_text_byte_equal(jax_ref, monkeypatch, learner):
    import jax
    from lightgbm_tpu.ops.split import find_best_split
    from lightgbm_tpu.treelearner import serial

    if learner == "serial":
        def op_by_op(*args):
            with jax.disable_jit():
                return find_best_split(*args)

        monkeypatch.setattr(serial, "find_best_split", op_by_op)
    params = {**RANK_PARAMS, "objective": "none"}
    (port, port_evals), (ref, ref_evals) = _train_both(
        jax_ref, monkeypatch, params, learner, fobj=SnappedLambdarank())
    assert port.num_trees() == ref.num_trees() == 3
    if learner == "serial":
        assert port.model_to_string() == ref.model_to_string()
    else:
        _assert_text_equal_but_gain(port.model_to_string(), ref.model_to_string(), 0.1)
    np.testing.assert_allclose(port_evals, ref_evals, rtol=0, atol=METRIC_ATOL)


def test_async_pipeline_bit_identical_with_position_debias():
    """A learning rate exact in float32 sends lambdarank through the async
    pipeline; the objective is called once an iteration in the same order,
    so its position biases and the model match the synchronous run's."""
    X, y, sizes = rank_data()
    runs = []
    for asyn in (True, False):
        ds = lt.Dataset(X, label=y, group=sizes, position=shown_positions(sizes))
        bst = lt.Booster({**RANK_PARAMS, "objective": "lambdarank", "learning_rate": 0.125,
                          "num_leaves": WAVE_LEAVES, "metric": "None"}, ds)
        gbdt = bst._gbdt
        gbdt.tree_learner = DeviceTreeLearner(gbdt.config, ds._handle, CPU)
        gbdt._async_pipeline = asyn
        for _ in range(3):
            bst.update()
        assert gbdt._async_enabled() == asyn
        runs.append((bst.model_to_string(), gbdt.score.numpy().copy(),
                     gbdt.objective._pos_biases.numpy().copy()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][2], runs[1][2])


RESUME_CASES = {"rank_xendcg": ({"objective": "rank_xendcg"}, False),
                "lambdarank_debiased": ({"objective": "lambdarank",
                                         "lambdarank_position_bias_regularization": 0.1}, True)}


def _resume_run(pkg, params, position, tmp_path, callbacks=None, init_model=None, rounds=6):
    X, y, sizes = rank_data()
    pos = shown_positions(sizes) if position else None
    return pkg.train({**RANK_PARAMS, **params, "metric": "None"},
                     pkg.Dataset(X, label=y, group=sizes, position=pos),
                     num_boost_round=rounds, callbacks=callbacks, init_model=init_model)


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_checkpoint_resume_byte_equal(tmp_path, case):
    params, position = RESUME_CASES[case]
    path = str(tmp_path / "ckpt_3.txt")
    straight = _resume_run(lt, params, position, tmp_path, callbacks=[checkpoint_callback(
        lambda it: str(tmp_path / f"ckpt_{it}.txt"), period=3)])
    state = load_checkpoint(path)
    assert state is not None and state.iteration == 3
    if position:
        assert state.objective["pos_biases"].dtype == np.float32
    else:
        assert state.objective == {"iter": 3}
    resumed = _resume_run(lt, params, position, tmp_path, init_model=path)
    assert resumed.model_to_string() == straight.model_to_string()
    np.testing.assert_array_equal(resumed._gbdt.score.numpy(), straight._gbdt.score.numpy())


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_jax_resume_loses_the_objective_state(jax_ref, tmp_path, case):
    """Fault 7 of the reference (ROADMAP Queue 3): the JAX sidecar carries
    no objective state, so its resumed run draws xendcg's uniforms from
    iteration 1 again, or restarts the position biases at 0, and its model
    differs from its own uninterrupted run."""
    from lightgbm_tpu.checkpoint import checkpoint_callback as jax_checkpoint_callback

    params, position = RESUME_CASES[case]
    path = str(tmp_path / "jax_ckpt_3.txt")
    straight = _resume_run(jax_ref, params, position, tmp_path, callbacks=[
        jax_checkpoint_callback(lambda it: str(tmp_path / f"jax_ckpt_{it}.txt"), period=3)])
    resumed = _resume_run(jax_ref, params, position, tmp_path, init_model=path)
    assert resumed.current_iteration() == straight.current_iteration() == 6
    first, again = (b.model_to_string().split("Tree=")[1:] for b in (straight, resumed))
    assert first[:3] == again[:3]  # the trees before the checkpoint
    assert first[3:] != again[3:]


def test_cv_on_a_ranking_dataset_fails_as_in_jax(jax_ref):
    """A fold is a row subset, and a subset keeps no query structure
    (io/metadata.py:subset, in both packages): the ranking objective refuses
    it. A splitter gets the query sizes as `groups=`, one value a query and
    not a row, and scikit-learn refuses them."""
    from sklearn.model_selection import GroupKFold

    X, y, sizes = rank_data()
    params = {**RANK_PARAMS, "objective": "lambdarank"}
    for pkg in (lt, jax_ref):
        with pytest.raises(Exception, match="query information") as err:
            pkg.cv(dict(params), pkg.Dataset(X, label=y, group=sizes), num_boost_round=2,
                   nfold=3)
        assert err.type.__name__ == "LightGBMError"
        with pytest.raises(ValueError, match="inconsistent numbers of samples"):
            pkg.cv(dict(params), pkg.Dataset(X, label=y, group=sizes), num_boost_round=2,
                   folds=GroupKFold(n_splits=3))


def test_dataset_group_and_position_setters(jax_ref):
    X, y, sizes = rank_data()
    pos = shown_positions(sizes)
    for pkg in (lt, jax_ref):
        ds = pkg.Dataset(X, label=y).construct()
        ds.set_group(sizes).set_position(pos)
        md = ds._handle.metadata
        np.testing.assert_array_equal(md.query_boundaries, np.concatenate([[0],
                                                                            np.cumsum(sizes)]))
        np.testing.assert_array_equal(md.position_ids[md.positions], pos)
        valid = ds.create_valid(X[:200], label=y[:200], group=[100, 100], position=pos[:200])
        valid.construct()
        np.testing.assert_array_equal(valid._handle.metadata.query_boundaries, [0, 100, 200])
        assert valid._handle.metadata.positions is not None
    port = lt.Dataset(X, label=y, group=sizes, position=pos)
    assert port.get_group() is sizes and port.get_position() is pos
