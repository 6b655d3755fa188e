"""The sharded wave learners (lightgbm_tpu_torch/parallel/wave_learners.py)
on gloo gangs of 2 and 4 CPU ranks, against the port's single-process
wave learner (DeviceTreeLearner) and the JAX package's
DeviceDataParallelTreeLearner, VotingDataParallelTreeLearner and
DeviceFeatureParallelTreeLearner at the same world size
(``LGBM_TPU_FORCE_MESH_DEVICES``).

Contracts, on grid-snapped gradients: every rank grows the same trees;
data-, voting- (top_k >= F) and feature-parallel trees, bagged or not, are
the single-process wave learner's exactly and the JAX package's line for
line but split_gain (4 ULP of the un-shifted gain: the JAX scan runs
jitted), with the same leaf ids; voting at top_k=2 of 7 (float, and
bagged quantized) is the JAX package's in the same sense, and not the
exact learner's; quantized (int32 histograms, exact in
any order) likewise; the packed int16 wire is chosen from the GLOBAL
in-bag count (num_grad_quant_bins 32: 1,200 rows do not fit it, a 900-row
bag does, though every rank's own rows would) and leaves the trees
unchanged; the wire gauges do not change with the row count.
One gang a world size grows every case.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.torch_gang import N_ROWS, data, run_gang, snapped_gh

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5}
QUANT = dict(BASE, use_quantized_grad=True, num_grad_quant_bins=4)
WIDE = dict(BASE, use_quantized_grad=True, num_grad_quant_bins=32)
BAG = np.sort(np.random.RandomState(3).choice(N_ROWS, 900, replace=False)).astype(np.int32)
MODES = {"data": "DeviceDataParallelTreeLearner", "voting": "VotingDataParallelTreeLearner",
         "feature": "DeviceFeatureParallelTreeLearner"}
JAX_MODES = {"data": "DeviceDataParallelTreeLearner",
             "voting": "VotingDataParallelTreeLearner",
             "feature": "DeviceFeatureParallelTreeLearner"}
CASES = [(mode, bagged, quantized) for mode in MODES for bagged in (False, True)
         for quantized in (False, True)]
IDS = [f"{m}{'-bagged' if b else ''}{'-quantized' if q else ''}" for m, b, q in CASES]
# voting at top_k=2 of 7 features: four elected a leaf, so the election
# decides the splits; (bagged, quantized), after every other job. A rank's
# nominations come from its own rows, so the trees depend on where the
# shards split: the JAX package pads each shard to its 1,024-row tile
# (1,200 rows split 1,024 / 176 there, 600 / 600 here), so these take
# 4,096 rows, which both cut into the same blocks at 2 and 4 ranks
NARROW = [(False, False), (True, True)]
NARROW_ROWS = 4096
NARROW_BAG = np.sort(np.random.RandomState(4).choice(NARROW_ROWS, 3000, replace=False)
                     ).astype(np.int32)


def _params(mode, quantized):
    p = dict(QUANT if quantized else BASE)
    if mode == "voting":
        p["top_k"] = 20
    return p


def _jobs():
    jobs = [(MODES[m], _params(m, q), {"bag": BAG if b else None}) for m, b, q in CASES]
    jobs += [(MODES["data"], WIDE, {}), (MODES["data"], WIDE, {"bag": BAG}),
             (MODES["data"], BASE, {"n_rows": 2 * N_ROWS, "n_trees": 1}),
             (MODES["voting"], _params("voting", False), {"n_rows": 2 * N_ROWS, "n_trees": 1}),
             (MODES["feature"], BASE, {"n_rows": 2 * N_ROWS, "n_trees": 1})]
    jobs += [(MODES["voting"], dict(QUANT if q else BASE, top_k=2),
              {"bag": NARROW_BAG if b else None, "n_rows": NARROW_ROWS}) for b, q in NARROW]
    return jobs


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def gang(request, gangs):
    return request.param, gangs(request.param)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """size -> every rank's results, one gang a size, run at first use."""
    done = {}

    def get(size):
        if size not in done:
            done[size] = run_gang("grow_many", size, tmp_path_factory.mktemp(f"wave{size}"),
                                  _jobs())
        return done[size]

    return get


@pytest.fixture(scope="module")
def single():
    """The single-process wave learner on each case's inputs."""
    from tests.torch_gang import grow_trees

    out = [grow_trees("DeviceTreeLearner", dict(QUANT if q else BASE),
                      bag=BAG if b else None) for _, b, q in CASES]
    out += [grow_trees("DeviceTreeLearner", WIDE), grow_trees("DeviceTreeLearner", WIDE, bag=BAG)]
    return out


def _fields(text):
    return dict(line.split("=", 1) for line in text.splitlines() if "=" in line)


def _assert_tree_equal_but_gain(port, ref, rate=1.0):
    a, b = _fields(port), _fields(ref)
    assert a.keys() == b.keys()
    for key in a:
        if key != "split_gain":
            assert a[key] == b[key], key
    if "split_gain" in a:
        gx, gy = (np.array(t["split_gain"].split(), np.float32) for t in (a, b))
        out = np.array(a["internal_value"].split(), np.float32) / np.float32(rate)
        sum_h = np.array(a["internal_weight"].split(), np.float32)
        ulp = np.spacing(np.abs(gy) + out * out * sum_h)
        assert (np.abs(gx - gy) <= 4 * ulp).all(), (gx, gy)


def test_every_rank_grows_the_same_trees(gang):
    size, out = gang
    for j in range(len(out[0])):
        for t in range(len(out[0][j])):
            assert len({r[j][t]["tree"] for r in out}) == 1
            assert all(np.array_equal(r[j][t]["ids"], out[0][j][t]["ids"]) for r in out)


@pytest.mark.parametrize("j", range(len(CASES)), ids=IDS)
def test_trees_equal_the_single_process_wave_learner(gang, single, j):
    size, out = gang
    for got, want in zip(out[0][j], single[j]):
        assert got["tree"] == want["tree"]
        np.testing.assert_array_equal(got["ids"], want["ids"])


# the JAX package's side compiles a sharded grower a case (~5 s each): every
# mode at each world size, each lane (bagged, quantized) in some
JAX_CASES = [(2, c) for c in ("data", "data-quantized", "voting-bagged-quantized",
                              "feature-bagged")] + \
    [(4, c) for c in ("data-bagged", "voting", "feature-quantized")]


@pytest.mark.parametrize("size,case", JAX_CASES, ids=[f"ranks{n}-{c}" for n, c in JAX_CASES])
def test_trees_match_jax(jax_ref, monkeypatch, gangs, size, case):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.parallel import learners as jl

    out = gangs(size)
    j = IDS.index(case)
    mode, bagged, quantized = CASES[j]
    monkeypatch.setenv("LGBM_TPU_FORCE_MESH_DEVICES", str(size))
    X, y = data()
    cfg = JConfig(dict(_params(mode, quantized), verbosity=-1))
    learner = getattr(jl, JAX_MODES[mode])(cfg, JDataset.from_matrix(X, label=y, config=cfg))
    import jax.numpy as jnp

    for t, got in enumerate(out[0][j]):
        pending = learner.train_async(jnp.asarray(snapped_gh(100 + t)),
                                      BAG if bagged else None)
        tree = learner.finalize(pending)
        _assert_tree_equal_but_gain(got["tree"], tree.to_string())
        np.testing.assert_array_equal(got["ids"], np.asarray(learner.partition.ids_host))


NARROW_JAX = [(2, 0), (4, 0), (4, 1)]


@pytest.mark.parametrize("size,k", NARROW_JAX,
                         ids=[f"ranks{n}-voting-top2{'-bagged-quantized' if NARROW[k][0] else ''}"
                              for n, k in NARROW_JAX])
def test_narrow_vote_matches_jax(jax_ref, monkeypatch, gangs, size, k):
    """top_k=2: the nomination, the election, the reduction of the elected
    slices and the rescan against the JAX package's wave learner, and the
    election bites (the trees are not the exact data-parallel learner's)."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.parallel import learners as jl
    import jax.numpy as jnp

    out = gangs(size)
    bagged, quantized = NARROW[k]
    j = len(_jobs()) - len(NARROW) + k
    monkeypatch.setenv("LGBM_TPU_FORCE_MESH_DEVICES", str(size))
    X, y = data(n=NARROW_ROWS)
    cfg = JConfig(dict(QUANT if quantized else BASE, top_k=2, verbosity=-1))
    learner = jl.VotingDataParallelTreeLearner(cfg, JDataset.from_matrix(X, label=y,
                                                                         config=cfg))
    exact = jl.DeviceDataParallelTreeLearner(cfg, JDataset.from_matrix(X, label=y, config=cfg))
    bag = NARROW_BAG if bagged else None
    differs = False
    for t, got in enumerate(out[0][j]):
        gh = jnp.asarray(snapped_gh(100 + t, NARROW_ROWS))
        _assert_tree_equal_but_gain(got["tree"],
                                    learner.finalize(learner.train_async(gh, bag)).to_string())
        np.testing.assert_array_equal(got["ids"], np.asarray(learner.partition.ids_host))
        differs |= got["tree"] != exact.finalize(exact.train_async(gh, bag)).to_string()
    assert differs


def test_int16_wire_from_the_global_in_bag_count(gang, single):
    """32 quantization bins: 1,200 rows overflow int16's bound, so the wire
    is int32 (4 bytes a value); a 900-row bag fits it, and the packed int16
    wire (2 bytes) carries the same trees; every rank's own rows (300-600)
    would fit it either way."""
    size, out = gang
    n = len(CASES)
    wide, narrow = out[0][n], out[0][n + 1]
    w_bytes = wide[-1]["counters"]["device_ici_bytes_per_wave"]
    n_bytes = narrow[-1]["counters"]["device_ici_bytes_per_wave"]
    assert n_bytes < w_bytes
    for got, want in zip(wide + narrow, single[n] + single[n + 1]):
        assert got["tree"] == want["tree"]


def test_wire_gauges_do_not_depend_on_the_row_count(gang):
    """The same learner at 1,200 and 2,400 rows publishes the same bytes a
    wave (data, voting, feature)."""
    size, out = gang
    n = len(CASES) + 2
    for k, mode in enumerate(("data", "voting", "feature")):
        small = out[0][CASES.index((mode, False, False))][0]["counters"]
        large = out[0][n + k][0]["counters"]
        key = "device_ici_bytes_per_wave"
        assert small[key] == large[key] > 0
        if mode != "data":
            assert small[f"{mode}_ici_bytes_per_wave"] == small[key]


def test_counted_wire_bytes_match_the_model(gang):
    """The bytes each rank hands the collectives during the waves (live and
    after the end) equal perfmodel's bytes a wave at each tree's width
    times its waves, for every case: float, bagged, quantized (int32 and
    the packed int16 wire)."""
    size, out = gang
    for j in range(len(CASES) + 2):
        for r in out:
            c = r[j][-1]["counters"]
            assert c["wave_wire_bytes"] == c["wave_wire_model_bytes"] > 0, (j, c)
        c = out[0][j][0]["counters"]
        assert c["wave_wire_bytes"] == c["device_ici_bytes_per_wave"] * c["wave_wire_waves"]


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nonfinite"])
def test_image_plain_versions_convert_to_the_fixed_point_emulation(nonfinite):
    """The image modes' plain versions (what the ranks add) converted by the
    conversion's plain version are the float modes' fixed-point emulation,
    non-finite cells included; the subtraction of images follows float
    arithmetic on the cells it marks."""
    from lightgbm_tpu_torch.ops import histogram as H

    g = torch.Generator().manual_seed(4)
    G, N, B, K = 3, 600, 16, 3
    bins = torch.randint(0, B, (G, N), dtype=torch.uint8, generator=g)
    gh = torch.randn(N, 3, generator=g)
    if nonfinite:
        gh[1, 0], gh[2, 1], gh[3, 2], gh[4, 0] = (float("inf"), float("-inf"), float("nan"),
                                                  float("-inf"))
    slot = torch.randint(0, K + 1, (N,), dtype=torch.int32, generator=g)
    starts = torch.tensor([0, 200, 400], dtype=torch.int32)
    ends = torch.tensor([180, 390, 600], dtype=torch.int32)
    valid = torch.ones(K, dtype=torch.bool)
    exps = H.fixed_point_exponents(gh, N)
    img = H._histogram_slots_ragged_image_plain(bins, gh, slot, starts, ends, valid, B, K,
                                                exps)
    got = H._image_to_float_plain(img.sums, img.flags, exps)
    want = H._histogram_slots_ragged_fixed(bins, gh, slot, starts, ends, valid, B, K, exps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((img.flags != 0).any()) == nonfinite
    rows = H._histogram_rows_image_plain(bins, gh, None, B, None, exps)
    assert torch.equal(H.image_to_float(rows, exps).view(torch.int32),
                       H._build_histogram_rows_fixed(bins, gh, None, B, exps).view(torch.int32))
    # the subtraction trick on images: each code against float arithmetic
    codes = torch.arange(4, dtype=torch.int32)
    a = H.HistImage(torch.zeros(16, dtype=torch.int64), codes.repeat_interleave(4))
    b = H.HistImage(torch.zeros(16, dtype=torch.int64), codes.repeat(4))
    vals = torch.tensor([0.0, float("inf"), float("-inf"), float("nan")])
    diff = H._image_to_float_plain(H.image_sub(a, b).sums, H.image_sub(a, b).flags,
                                   torch.zeros(1, dtype=torch.int32))
    ref = vals.repeat_interleave(4) - vals.repeat(4)
    assert torch.equal(torch.isnan(diff), torch.isnan(ref))
    assert torch.equal(diff[~torch.isnan(ref)], ref[~torch.isnan(ref)])


def test_image_pool_grows_the_float_pool_trees():
    """The wave learner's image pool (the card's: fixed-point images,
    converted after the subtraction), forced on the CPU with the plain
    versions, grows the float pool's tree on snapped gradients."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
    from lightgbm_tpu_torch.treelearner.device import (DeviceTreeLearner, WaveBuffers,
                                                       grow_tree_on_device)

    X, y = data()
    cfg = Config(dict(BASE, num_leaves=31, verbosity=-1))
    tl = DeviceTreeLearner(cfg, CoreDataset.from_matrix(X, label=y, config=cfg), "cpu")
    gh = torch.from_numpy(snapped_gh(7)[:-1])
    leaf0 = torch.zeros(N_ROWS, dtype=torch.int32)
    out = []
    for image in (False, True):
        buf = WaveBuffers(tl.bins_dev.shape[0], N_ROWS, 5, 31, tl.group_bin_padded, 3,
                          len(tl.meta.real_feature), "cpu", image=image)
        assert buf.image == image and (buf.pool.dtype == torch.int64) == image
        out.append(grow_tree_on_device(tl.bins_dev, gh, leaf0, tl.meta, tl.tables,
                                       tl.params_dev, None, 31, tl.group_bin_padded, 0,
                                       batch=4, buffers=buf))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and out[0][2] == out[1][2] == 31
