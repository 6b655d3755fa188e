"""Prediction early stopping's block (`ops/predict.py:_early_stop_block_plain`,
the plain version of the kernel `ops/predict_cuda.py:early_stop_block`) on
the CPU.

Contracts:

* the block equals, bit for bit, the composition the loop ran before it
  (the active mask's nonzero positions, the sums and rows gathered,
  `_predict_raw_fused` with `init`, the sums scattered back, the margin and
  the mask written), block by block through a whole early-stopped predict:
  scores byte-equal, the active set equal. Cases: one class and three;
  margins 0, 4, inf and a negative one; a block where every row stops; an
  empty list; a last block shorter than the round period; NaN and +-inf in
  X; running scores that make torch.topk meet NaN, +-inf and ties;
* against the JAX package's `_early_stop_block` (with `_compact_active`),
  block by block, on forests whose leaf values are multiples of 1/64 so
  that every order of float32 adds is exact: scores byte-equal, active sets
  equal;
* `predict_raw_early_stop` launches the block once a block, whatever the
  count (the loop reads nothing between blocks), reads the counts once at
  the end, and tallies the same row-trees as the composition.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from lightgbm_tpu_torch.ops import predict_cuda
from lightgbm_tpu_torch.ops.predict import (_early_stop_block_plain, _predict_raw_fused,
                                            pack_ensemble, predict_raw_early_stop)
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_ref import jax_ref  # noqa: F401

N, F = 400, 6


def _forest(C, iters, seed, dyadic=False):
    model = random_model(np.random.RandomState(seed), F, iters, 15, num_class=C,
                         cat_features=(2,) if C > 1 else (),
                         objective="binary sigmoid:1" if C == 1 else f"multiclass num_class:{C}")
    if dyadic:
        for tree in model.trees:
            tree.leaf_value = np.round(np.asarray(tree.leaf_value) * 64) / 64
    return model


def _rows(seed, C, special=True):
    X = make_rows(np.random.RandomState(seed), N, F, (2,) if C > 1 else ())
    if special:
        rng = np.random.RandomState(seed + 1)
        X[rng.rand(N, F) < 0.03] = np.inf
        X[rng.rand(N, F) < 0.03] = -np.inf
    return torch.from_numpy(X)


def _composition_block(packed, X, scores, active, C, margin):
    """The early-stopping loop's body before the kernel: nonzero, gather,
    accumulate, scatter, margin, mask."""
    idx = torch.nonzero(active).reshape(-1)
    if idx.shape[0] == 0:
        return 0
    sums = _predict_raw_fused(packed, X[idx], C, scores[idx])
    scores[idx] = sums
    if C == 1:
        margin_val = 2.0 * torch.abs(sums[:, 0])
    else:
        top2 = torch.topk(sums, 2, dim=1).values
        margin_val = top2[:, 0] - top2[:, 1]
    active[idx] = ~(margin_val > torch.tensor(margin, dtype=torch.float32))
    return idx.shape[0]


def _both_loops(packed, X, C, period, margin, init=None):
    """Run the composition and the plain block side by side, block by block,
    asserting equal scores and active sets after each; returns the blocks'
    active counts."""
    n, T = X.shape[0], packed.num_trees
    block = period * C
    s_old = torch.zeros((n, C)) if init is None else init.clone()
    s_new = s_old.clone()
    active = torch.ones(n, dtype=torch.bool)
    lists = torch.full((2, n), -1, dtype=torch.int32)
    counts = torch.zeros(-(-T // block) + 1, dtype=torch.int32)
    counts[0] = n
    m32 = torch.tensor(margin, dtype=torch.float32).item()
    seen = []
    for b, start in enumerate(range(0, T, block)):
        sl = packed.tree_slice(start, min(start + block, T))
        seen.append(_composition_block(sl, X, s_old, active, C, margin))
        _early_stop_block_plain(sl, X, s_new, C, m32, None if b == 0 else lists[(b - 1) % 2],
                                counts[b:b + 1], lists[b % 2], counts[b + 1:b + 2])
        assert torch.equal(s_old.view(torch.int32), s_new.view(torch.int32)), b
        kept = lists[b % 2][:int(counts[b + 1])]
        assert torch.equal(torch.sort(kept.long()).values, torch.nonzero(active).reshape(-1)), b
        assert int(counts[b]) == seen[-1]
    return seen


CASES = [(1, 0.0), (1, 4.0), (1, float("inf")), (1, -1.0), (3, 0.0), (3, 0.5),
         (3, float("inf")), (3, -2.0)]


@pytest.mark.parametrize("C,margin", CASES, ids=[f"C{c}-m{m}" for c, m in CASES])
def test_plain_block_equals_the_composition(C, margin):
    # 7 iterations every 3: a last block of one iteration
    packed = pack_ensemble(_forest(C, 7, 10 + C).trees)
    X = _rows(20 + C, C)
    seen = _both_loops(packed, X, C, 3, margin)
    if margin < 0 or margin == 0.0:
        assert seen[1:] == [0] * (len(seen) - 1) or margin == 0.0
    if margin == float("inf"):
        assert seen == [N] * len(seen)


@pytest.mark.parametrize("C", [1, 3])
def test_plain_block_equals_the_composition_on_special_scores(C):
    """Running scores holding NaN, +-inf and ties, where torch.topk orders
    NaN above everything and inf - inf is NaN."""
    packed = pack_ensemble(_forest(C, 4, 30 + C).trees)
    X = _rows(40 + C, C)
    rng = np.random.RandomState(50 + C)
    init = rng.normal(size=(N, C)).astype(np.float32)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5], np.float32)
    pick = rng.rand(N, C) < 0.3
    init[pick] = rng.choice(specials, size=int(pick.sum()))
    if C > 1:
        init[:20, 1] = init[:20, 0]  # ties between the top two
        init[20:25] = np.inf
        init[25:30, :2] = np.nan
    for margin in (0.25, 3.0):
        _both_loops(packed, X, C, 2, margin, torch.from_numpy(init))


def test_plain_block_with_an_empty_list_writes_zero():
    packed = pack_ensemble(_forest(1, 3, 60).trees)
    X = _rows(61, 1)
    scores = torch.zeros((N, 1))
    rows_out = torch.full((N,), -1, dtype=torch.int32)
    counts = torch.tensor([0, 7], dtype=torch.int32)
    _early_stop_block_plain(packed, X, scores, 1, 1.0, torch.zeros(N, dtype=torch.int32),
                            counts[0:1], rows_out, counts[1:2])
    assert int(counts[1]) == 0 and not scores.any() and bool((rows_out == -1).all())


@pytest.mark.parametrize("C,period", [(1, 3), (3, 2)])
def test_plain_block_matches_jax_block_on_dyadic_leaves(jax_ref, C, period):
    import jax.numpy as jnp
    from lightgbm_tpu.models.serialize import GBDTModel as JaxModel
    from lightgbm_tpu.ops.partition import bucket_size
    from lightgbm_tpu.ops.predict import _compact_active, _early_stop_block
    from lightgbm_tpu.ops.predict import pack_ensemble as jax_pack

    model = _forest(C, 8, 70 + C, dyadic=True)
    packed = pack_ensemble(model.trees)
    jpacked = jax_pack(JaxModel.from_string(model.to_string()).trees)
    X = _rows(80 + C, C, special=False)
    Xj = jnp.asarray(X.numpy())
    T, block = packed.num_trees, period * C
    # a margin that the first block's 40th percentile row clears, off the
    # 1/64 grid of every dyadic sum
    first = _predict_raw_fused(packed.tree_slice(0, block), X, C)
    top = torch.topk(first, min(C, 2), dim=1).values
    spread = 2 * top[:, 0].abs() if C == 1 else top[:, 0] - top[:, 1]
    margin = float(np.floor(np.quantile(spread.numpy(), 0.4) * 64) / 64 + 1 / 128)
    scores = torch.zeros((N, C))
    js, jactive = jnp.zeros((N, C), jnp.float32), jnp.ones(N, jnp.bool_)
    lists = torch.empty((2, N), dtype=torch.int32)
    counts = torch.zeros(-(-T // block) + 1, dtype=torch.int32)
    counts[0] = N
    stopped_some = False
    for b, start in enumerate(range(0, T, block)):
        end = min(start + block, T)
        _early_stop_block_plain(packed.tree_slice(start, end), X, scores, C, margin,
                                None if b == 0 else lists[(b - 1) % 2], counts[b:b + 1],
                                lists[b % 2], counts[b + 1:b + 2])
        cnt = int(jnp.sum(jactive, dtype=jnp.int32))
        assert cnt == int(counts[b])
        if cnt:
            idx = _compact_active(jactive, min(bucket_size(cnt, 256), N))
            js, jactive = _early_stop_block(jpacked.tree_slice(start, end), Xj, js, jactive,
                                            idx, jnp.int32(cnt), margin, C)
        assert np.array_equal(scores.numpy().view(np.int32), np.asarray(js).view(np.int32)), b
        kept = np.sort(lists[b % 2][:int(counts[b + 1])].numpy())
        assert np.array_equal(kept, np.nonzero(np.asarray(jactive))[0]), b
        stopped_some |= int(counts[b + 1]) < N
    assert stopped_some and int(counts[-1]) > 0


def test_loop_launches_every_block_and_reads_the_counts_once(monkeypatch):
    """The loop calls the block once a block (after every row has stopped
    too: the count lives on the device), and its row-tree tally equals the
    composition's."""
    C, period, margin = 1, 2, 0.5
    packed = pack_ensemble(_forest(C, 9, 90).trees)
    X = _rows(91, C)
    calls = []
    real = predict_cuda.early_stop_block

    def counted(*args, **kwargs):
        calls.append(args[5] is None)
        return real(*args, **kwargs)

    monkeypatch.setattr(predict_cuda, "early_stop_block", counted)
    before = global_timer.counters.get("predict_early_stop_row_trees", 0)
    got = predict_raw_early_stop(packed, X, C, period, margin)
    walked = global_timer.counters["predict_early_stop_row_trees"] - before
    blocks = -(-packed.num_trees // (period * C))
    assert calls == [True] + [False] * (blocks - 1)
    scores, active = torch.zeros((N, C)), torch.ones(N, dtype=torch.bool)
    tally = 0
    for start in range(0, packed.num_trees, period * C):
        end = min(start + period * C, packed.num_trees)
        tally += _composition_block(packed.tree_slice(start, end), X, scores, active, C,
                                    margin) * (end - start)
    assert torch.equal(got, scores) and walked == tally
    assert predict_raw_early_stop(packed, X, C, period, -1.0).shape == (N, C)
    assert len(calls) == 2 * blocks
