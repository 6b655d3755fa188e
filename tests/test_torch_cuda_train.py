"""The CUDA histogram (leaf and ragged), compaction and split-scan kernels
against their plain PyTorch versions, and training on the card (the serial
and the wave learner) against training on the CPU.

Marked `gpu`: these need an NVIDIA card with nvcc, and skip elsewhere.
Run them on the card with `python -m pytest -m gpu tests/test_torch_cuda_train.py`.
Whether a card is present is decided inside the fixture, never at import,
so every test worker collects the same tests.

Contracts: the histogram is exact on grid-snapped gradients and in the
integer mode, within the float32 summation bound P * 2**-24 * sum|v| per
bin otherwise, and bit-equal from one launch to the next. The split
kernel's records (per feature, and the find form's one record a leaf from
the group histogram) equal the plain version's run on the CPU on the same
histogram, field for field; the gain within 4 ULP of the un-shifted gain;
the leaf batch gives each leaf the one-leaf launch's bits. The ragged
histogram is held as the leaf histogram is; the compaction and the wave
partition move bits exactly, and the partition's slot vector, left counts
and children's ranges equal the plain version's. On snapped gradients the
model text trained on the card equals the CPU's, through either learner,
with and without bagging. The wave's selection and replay kernels equal
their plain versions run on the CPU exactly (tables, state, split log bits,
commit tables, done word), and the wave learner's tree grown on the card,
one CUDA graph launch a tree (the root's graph and a WHILE node of two wave
graphs), is byte-equal to the one grown on the CPU and to the loop driven
from the host on the card, with every kernel it ran counted; buffers reused
at a new width or with a mask capture a new tree graph. train_async
returns before the card has finished the tree. Multiclass on snapped
gradients trains on the card as on the CPU through both learners, and the
async pipeline on the card is bit-identical to the synchronous path. GOSS's
selection on the card is bit-equal to the CPU's, and GOSS and categorical
training (the categorical scan a CUDA graph a shape) on the card are
byte-equal to the CPU's. DART (snapped gradients) and RF (labels on a 1/64
grid) through the wave learner on the card are byte-equal to the CPU's; a
checkpoint taken with the async pipeline running resumes on the card
bit-identically; refit's leaf sums on the card equal the CPU's. The
traversal kernel's accumulate mode equals the plain version in both plans,
and prediction early stopping on the card equals the CPU's bit for bit. The
ranking objectives' gradients on the card are within 1e-5 of the CPU's
(xendcg rtol 1e-5 / atol 1e-7; its uniforms bit-equal), NDCG and MAP within
1e-6; lambdarank on snapped gradients trains on the card as on the CPU
through both learners, and a rank_xendcg run resumed from a checkpoint on
the card is byte-equal to the uninterrupted one.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset
from lightgbm_tpu_torch.ops import compact_cuda, hist_cuda, partition_cuda, scan_cuda
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.ops.compact import _compact_rows_plain
from lightgbm_tpu_torch.ops.histogram import (_build_histogram_plain,
                                              _build_histogram_rows_fixed,
                                              _build_histogram_rows_plain,
                                              _histogram_slots_ragged_plain,
                                              fixed_point_exponents)
from lightgbm_tpu_torch.ops.partition import (RowPartition, _split_rows_plain,
                                              go_left_table)
from lightgbm_tpu_torch.ops import wave_cuda
from lightgbm_tpu_torch.ops.wave import (DONE, FeatureTables, replay_wave, select_wave,
                                         split_select)
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner, _grow
from test_torch_wave_cases import (WAVE_CASES, partition_inputs, wave_case, wave_children,
                                   wave_state, wave_tables_random)
from torch_grid_data import grid_regression
from torch_rank_data import SnappedLambdarank, rank_data, shown_positions

pytestmark = pytest.mark.gpu
PARAMS = [0.0, 0.0, 20.0, 1e-3, 0.0, 0.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _hist_inputs(seed, G, N, B, P, n_rows):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(G, N)).astype(np.uint8)
    bins[:, rng.rand(N) < 0.4] = 0
    gh = np.stack([rng.normal(size=N), rng.uniform(0, 0.5, size=N), np.ones(N)], 1)
    snapped = np.round(gh * 16) / 16
    ext = lambda a: np.concatenate([a, np.zeros((1, 3))]).astype(np.float32)  # noqa: E731
    idx = np.full(P, N, np.int32)
    idx[:n_rows] = np.sort(rng.choice(N, n_rows, replace=False))
    q = rng.randint(-127, 128, size=(N + 1, 3)).astype(np.int8)
    q[N] = 0
    return bins, ext(gh), ext(snapped), q, idx


# (G, N, B, P, rows): G not a multiple of the group block, one group, a
# leaf of only sentinels, two bins, an unpadded identity-sized leaf
HIST_SHAPES = [(7, 20000, 256, 16384, 12000), (1, 5000, 64, 4096, 3000),
               (28, 3000, 256, 256, 0), (3, 40000, 2, 65536, 40000),
               (28, 100000, 255, 131072, 99000)]


@pytest.mark.parametrize("shape", HIST_SHAPES, ids=[str(s) for s in HIST_SHAPES])
def test_histogram_kernel_matches_plain(cuda, shape):
    G, N, B, P, n_rows = shape
    bins, gh, snapped, q, idx = _hist_inputs(sum(shape), G, N, B, P, n_rows)
    b_d, i_d = torch.from_numpy(bins).to(cuda), torch.from_numpy(idx).to(cuda)
    before = dict(hist_cuda.launches)
    for leaf in (None, i_d):
        for values, exact in ((snapped, True), (gh, False)):
            v_d = torch.from_numpy(values).to(cuda)
            got = hist_cuda.histogram(b_d, v_d if leaf is not None else v_d[:N], leaf, B)
            again = hist_cuda.histogram(b_d, v_d if leaf is not None else v_d[:N], leaf, B)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            if leaf is None:
                ref = _build_histogram_plain(torch.from_numpy(bins),
                                             torch.from_numpy(values[:N]), B)
                absref = _build_histogram_plain(torch.from_numpy(bins),
                                                torch.from_numpy(np.abs(values[:N])), B)
                n_pos = N
            else:
                ref = _build_histogram_rows_plain(torch.from_numpy(bins),
                                                  torch.from_numpy(values),
                                                  torch.from_numpy(idx), B)
                absref = _build_histogram_rows_plain(
                    torch.from_numpy(bins), torch.from_numpy(np.abs(values)),
                    torch.from_numpy(idx), B)
                n_pos = P
            if exact:
                assert torch.equal(got.cpu(), ref)
            else:
                bound = n_pos * 2.0 ** -24 * absref.double()
                assert bool(((got.cpu().double() - ref.double()).abs() <= bound).all())
    q_d = torch.from_numpy(q).to(cuda)
    got = hist_cuda.histogram(b_d, q_d, i_d, B)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), _build_histogram_rows_plain(
        torch.from_numpy(bins), torch.from_numpy(q), torch.from_numpy(idx), B))
    # the integer mode counts apart
    assert hist_cuda.launches["histogram"] == before["histogram"] + 8
    assert hist_cuda.launches["histogram_i32"] == before["histogram_i32"] + 1


# (G, N, B, P, rows, count given): a leaf read to its count, the same read
# through its padding, every row (consecutive positions), a one-row leaf,
# HIGGS width
FIXED_SHAPES = [(7, 20000, 256, 16384, 12000, True), (7, 20000, 256, 16384, 12000, False),
                (3, 40000, 64, 65536, 40000, True), (5, 9000, 255, 256, 1, True),
                (28, 300000, 255, 131072, 99000, True)]


@pytest.mark.parametrize("shape", FIXED_SHAPES, ids=[str(s) for s in FIXED_SHAPES])
def test_histogram_kernel_bit_equal_to_fixed_point_emulation(cuda, shape):
    """The leaf histogram's float mode bit-equal to
    `_build_histogram_rows_fixed` with the exponents passed (as the serial
    learner passes them) and computed by the wrapper, two launches bit-equal,
    the integer mode exact, and a row of NaN / inf gh only in its own
    cells."""
    G, N, B, P, n_rows, with_count = shape
    bins, gh, _, q, idx = _hist_inputs(sum(shape), G, N, B, P, n_rows)
    gh[int(idx[0])] = [float("nan"), float("inf"), float("-inf")]
    b_d, i_d = torch.from_numpy(bins).to(cuda), torch.from_numpy(idx).to(cuda)
    g_d, q_d = torch.from_numpy(gh).to(cuda), torch.from_numpy(q).to(cuda)
    count = n_rows if with_count else None
    exps = fixed_point_exponents(torch.from_numpy(gh), N)
    assert torch.equal(fixed_point_exponents(g_d, N).cpu(), exps)
    ref = _build_histogram_rows_fixed(torch.from_numpy(bins), torch.from_numpy(gh),
                                      torch.from_numpy(idx), B, exps, count)
    before = hist_cuda.launches["histogram"]
    got = hist_cuda.histogram(b_d, g_d, i_d, B, count, exps.to(cuda))
    again = hist_cuda.histogram(b_d, g_d, i_d, B, count)
    torch.cuda.synchronize()
    assert hist_cuda.launches["histogram"] == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    plain = _build_histogram_rows_plain(torch.from_numpy(bins), torch.from_numpy(gh),
                                        torch.from_numpy(idx), B)
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(plain))
    assert torch.equal(torch.isinf(got.cpu()), torch.isinf(plain))
    got_q = hist_cuda.histogram(b_d, q_d, i_d, B, count)
    assert got_q.dtype == torch.int32
    assert torch.equal(got_q.cpu(), _build_histogram_rows_plain(
        torch.from_numpy(bins), torch.from_numpy(q), torch.from_numpy(idx), B))


def test_histogram_wrapper_rejects_bad_input(cuda):
    bins = torch.zeros((2, 100), dtype=torch.int32, device=cuda)
    gh = torch.zeros((101, 3), device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        hist_cuda.histogram(bins, gh, None, 16)
    with pytest.raises(ValueError, match="int32"):
        hist_cuda.histogram(bins.to(torch.uint8), gh,
                            torch.zeros(8, dtype=torch.int64, device=cuda), 16)


def _leaf_case(seed, nan_feature):
    """A dataset whose feature 2 has a NaN missing bin (or, with
    zero_as_missing, every feature a zero missing bin), and one leaf's
    histogram (from the kernel) and totals on the card."""
    rng = np.random.RandomState(seed)
    n = 30000
    X = rng.normal(size=(n, 9))
    if nan_feature:
        X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.2, 5] = 0.0
    ds = Dataset.from_matrix(X, label=np.zeros(n), config=Config(
        {} if nan_feature else {"zero_as_missing": True}))
    B = int(max(ds.group_bin_counts().max(), 2))
    gh = np.stack([rng.normal(size=n), rng.uniform(0.05, 0.5, size=n), np.ones(n)], 1)
    gh = np.concatenate([gh, np.zeros((1, 3))]).astype(np.float32)
    idx = np.full(32768, n, np.int32)
    idx[:20000] = np.sort(rng.choice(n, 20000, replace=False))
    hist = hist_cuda.histogram(torch.from_numpy(ds.bins).to("cuda"),
                               torch.from_numpy(gh).to("cuda"),
                               torch.from_numpy(idx).to("cuda"), B)
    return ds, B, hist, hist[0].sum(dim=0)


@pytest.mark.parametrize("nan_feature", [True, False])
@pytest.mark.parametrize("mask", ["none", "sampled", "empty", "penalty"])
def test_split_scan_kernel_matches_plain_on_cpu(cuda, nan_feature, mask):
    ds, B, hist, tot = _leaf_case(3 + nan_feature, nan_feature)
    meta_d = ts.make_feature_meta(ds, B, cuda)
    meta_h = ts.make_feature_meta(ds, B, "cpu")
    F = len(meta_h.real_feature)
    rng = np.random.RandomState(7)
    fmask = {"none": None, "sampled": rng.rand(F) < 0.7,
             "empty": np.zeros(F, bool), "penalty": rng.rand(F) < 0.9}[mask]
    pen = rng.uniform(0, 3, size=F).astype(np.float32) if mask == "penalty" else None
    fh = ts.gather_feature_hist(hist, meta_d, tot)
    before = scan_cuda.launches["split_scan"]
    rec = scan_cuda.split_scan(
        fh, tot, meta_d, torch.tensor(PARAMS, device=cuda),
        None if fmask is None else torch.from_numpy(fmask).to(cuda),
        None if pen is None else torch.from_numpy(pen).to(cuda)).cpu()
    assert scan_cuda.launches["split_scan"] == before + 1
    ref = ts.per_feature_best(fh.cpu(), tot.cpu(), meta_h, torch.tensor(PARAMS),
                              None if fmask is None else torch.from_numpy(fmask),
                              None if pen is None else torch.from_numpy(pen))
    assert torch.equal(rec[:, 1:], ref[:, 1:])
    finite = torch.isfinite(ref[:, 0])
    assert torch.equal(torch.isfinite(rec[:, 0]), finite)
    shift = ts.leaf_gain(tot[0].cpu(), tot[1].cpu(), *torch.tensor(PARAMS)[[0, 1, 5]])
    ulp = np.spacing(np.abs((ref[:, 0] + shift).numpy()).astype(np.float32))
    assert (np.abs((rec[:, 0] - ref[:, 0]).numpy())[finite.numpy()]
            <= 4 * ulp[finite.numpy()]).all()
    if mask == "empty":
        assert (rec[:, 1] == -1).all()
    else:
        assert (rec[:, 1] >= 0).any()


def _snapped_logloss(preds, dataset):
    p = 1.0 / (1.0 + np.exp(-preds))
    grad = np.round((p - dataset.get_label()) * 16) / 16
    hess = np.round(np.maximum(p * (1.0 - p), 1.0 / 16) * 16) / 16
    return grad, hess


def test_train_on_card_byte_equal_to_cpu(cuda):
    rng = np.random.RandomState(11)
    X = rng.normal(size=(20000, 10))
    X[rng.rand(20000, 10) < 0.03] = np.nan
    y = (X[:, 0] + np.nan_to_num(X[:, 3]) > 0).astype(np.float64)
    params = {"objective": _snapped_logloss, "num_leaves": 63,
              "feature_fraction_bynode": 0.8, "verbosity": -1}
    hist_before = hist_cuda.launches["histogram"]
    scan_before = scan_cuda.launches["find_best_split"]
    part_before = dict(partition_cuda.launches)
    card = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=3)
    assert hist_cuda.launches["histogram"] > hist_before
    assert scan_cuda.launches["find_best_split"] > scan_before
    splits = sum(tr.num_leaves - 1 for tr in card._gbdt.models)
    assert partition_cuda.launches["row_partition"] == part_before["row_partition"] + splits
    host = lt.train({**params, "device_type": "cpu"}, lt.Dataset(X, label=y),
                    num_boost_round=3)
    assert card.model_to_string() == host.model_to_string()


# (G, N, B, ranges): one range over every row, spread ranges with an empty
# and an invalid one (-1 marks it), adjacent tiny ranges, HIGGS width
RAGGED_SHAPES = [
    (7, 50000, 256, [(0, 50000)]),
    (5, 40000, 64, [(0, 7000), (7000, 7000), (9000, -20000), (21000, 39999)]),
    (3, 9000, 16, [(0, 3), (3, 10), (10, 11), (500, 8999)]),
    (28, 300000, 255, [(s, s + 6000 + 331 * k) for k, s in
                       enumerate(range(0, 290000, 14000))]),
]


@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=["root", "spread", "tiny", "higgs"])
def test_ragged_histogram_kernel_matches_plain(cuda, shape):
    G, N, B, ranges = shape
    rng = np.random.RandomState(G + N)
    bins = rng.randint(0, B, size=(G, N)).astype(np.uint8)
    bins[:, rng.rand(N) < 0.4] = 0
    K = len(ranges)
    starts = np.array([s for s, _ in ranges], np.int32)
    ends = np.abs(np.array([e for _, e in ranges])).astype(np.int32)
    valid = np.array([e >= 0 for _, e in ranges])
    slot = np.full(N, K, np.int32)
    for k in range(K):
        slot[starts[k]:ends[k]] = k
    slot[rng.rand(N) < 0.03] = K  # a few dump rows inside the ranges
    gh = np.stack([rng.normal(size=N), rng.uniform(0, 0.5, N), np.ones(N)], 1)
    # the wave learner's payload: gh in the first columns of a [N, 5] row
    payload = np.zeros((N, 5), np.float32)
    t = torch.from_numpy
    args_h = [t(slot), t(starts), t(ends), t(valid)]
    args_d = [a.to(cuda) for a in args_h]
    b_d = t(bins).to(cuda)
    before = dict(hist_cuda.launches)
    for mode in ("snapped", "real", "quantized"):
        values = {"snapped": np.round(gh * 16) / 16, "real": gh,
                  "quantized": np.round(gh * 40)}[mode]
        payload[:, :3] = values
        q = mode == "quantized"
        p_d = t(payload).to(cuda)
        got = hist_cuda.histogram_ragged(b_d, p_d[:, :3], *args_d, B, K, q)
        again = hist_cuda.histogram_ragged(b_d, p_d[:, :3], *args_d, B, K, q)
        torch.cuda.synchronize()
        assert got.dtype == (torch.int32 if q else torch.float32)
        assert torch.equal(got, again)
        ref = _histogram_slots_ragged_plain(t(bins), t(payload)[:, :3], *args_h, B, K, q)
        if mode == "real":
            absref = _histogram_slots_ragged_plain(t(bins), t(np.abs(payload))[:, :3],
                                                   *args_h, B, K)
            bound = N * 2.0 ** -24 * absref.double()
            assert bool(((got.cpu().double() - ref.double()).abs() <= bound).all())
        else:
            assert torch.equal(got.cpu(), ref)
    # the integer mode counts apart
    assert hist_cuda.launches["histogram_slots_ragged"] == before["histogram_slots_ragged"] + 4
    assert hist_cuda.launches["histogram_slots_ragged_i32"] == \
        before["histogram_slots_ragged_i32"] + 2


# (name, G, N, B, ranges, bins): every row in bin 0 (all adds on one cell a
# group), empty and invalid ranges only (-1 marks invalid), and 1024 ranges
RAGGED_EDGES = [
    ("dominant_bin", 28, 200000, 255, [(0, 200000)], "zeros"),
    ("dominant_wave", 6, 60000, 64, [(s, s + 1500) for s in range(0, 58000, 2800)], "zeros"),
    ("empty_ranges", 4, 5000, 32, [(0, 0), (10, 10), (100, -3000), (4000, 4000)], "random"),
    ("k1024", 3, 1024 * 70, 16, [(70 * k, 70 * k + (k % 7) * 9) for k in range(1024)],
     "random"),
]


@pytest.mark.parametrize("case", RAGGED_EDGES, ids=[c[0] for c in RAGGED_EDGES])
def test_ragged_histogram_edge_cases(cuda, case):
    """Exact on snapped gradients and in the integer mode, bit-equal to the
    plain fixed-point emulation on real gradients (and so within the
    float32 summation bound), two launches bit-equal, and each range's
    columns equal to those of a launch over that range alone."""
    from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_ragged_fixed,
                                                  fixed_point_exponents)

    name, G, N, B, ranges, kind = case
    rng = np.random.RandomState(G * 7 + N)
    bins = (np.zeros((G, N), np.uint8) if kind == "zeros"
            else rng.randint(0, B, size=(G, N)).astype(np.uint8))
    K = len(ranges)
    starts = np.array([s for s, _ in ranges], np.int32)
    ends = np.abs(np.array([e for _, e in ranges])).astype(np.int32)
    valid = np.array([e >= 0 for _, e in ranges])
    slot = np.full(N, K, np.int32)
    for k in range(K):
        slot[starts[k]:ends[k]] = k
    gh = np.stack([rng.normal(size=N), rng.uniform(0, 0.5, N), np.ones(N)], 1)
    t = torch.from_numpy
    args_h = [t(slot), t(starts), t(ends), t(valid)]
    args_d = [a.to(cuda) for a in args_h]
    b_d = t(bins).to(cuda)
    for mode in ("snapped", "real", "quantized"):
        values = {"snapped": np.round(gh * 16) / 16, "real": gh,
                  "quantized": np.round(gh * 40)}[mode]
        g_h = t(values.astype(np.float32))
        g_d = g_h.to(cuda)
        q = mode == "quantized"
        got = hist_cuda.histogram_ragged(b_d, g_d, *args_d, B, K, q)
        again = hist_cuda.histogram_ragged(b_d, g_d, *args_d, B, K, q)
        torch.cuda.synchronize()
        assert torch.equal(got, again), mode
        ref = _histogram_slots_ragged_plain(t(bins), g_h, *args_h, B, K, q)
        if mode == "real":
            exps = fixed_point_exponents(g_h, N)
            assert torch.equal(fixed_point_exponents(g_d, N).cpu(), exps)
            assert torch.equal(got.cpu(), _histogram_slots_ragged_fixed(
                t(bins), g_h, *args_h, B, K, exps))
            absref = _histogram_slots_ragged_plain(t(bins), g_h.abs(), *args_h, B, K)
            bound = N * 2.0 ** -24 * absref.double()
            assert bool(((got.cpu().double() - ref.double()).abs() <= bound).all())
        else:
            assert torch.equal(got.cpu(), ref), mode
        # a range's columns do not depend on the other ranges of the launch
        k = int(np.argmax(ends - starts))
        one = [a[k:k + 1].contiguous() for a in args_d[1:]]
        slot_k = torch.where(args_d[0] == k, 0, 1).to(torch.int32)
        alone = hist_cuda.histogram_ragged(b_d, g_d, slot_k, *one, B, 1, q)
        assert torch.equal(alone, got[:, :, 3 * k:3 * k + 3]), mode


def nonfinite_case(seed, n, G, B, ranges, snapped):
    """(bins, gh, args): gh with NaN, +inf and -inf in a few rows of
    range 0 only, one bin of group 0 holding both an +inf and a -inf of one
    channel; args = [slot, starts, ends, valid] as CPU tensors."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(G, n)).astype(np.uint8)
    gh = np.stack([rng.normal(size=n), rng.uniform(0, 0.5, n), np.ones(n)], 1)
    if snapped:
        gh = np.round(gh * 16) / 16
    gh = gh.astype(np.float32)
    s0 = ranges[0][0]
    bad = [(s0 + 1, 0, np.nan), (s0 + 2, 0, np.inf), (s0 + 3, 1, -np.inf),
           (s0 + 4, 2, np.inf), (s0 + 5, 2, -np.inf), (s0 + 6, 1, np.nan)]
    for r, c, v in bad:
        gh[r, c] = v
    bins[0, s0 + 5] = bins[0, s0 + 4]
    K = len(ranges)
    slot = np.full(n, K, np.int32)
    for k, (s, e) in enumerate(ranges):
        slot[s:e] = k
    t = torch.from_numpy
    args = [t(slot), t(np.array([s for s, _ in ranges], np.int32)),
            t(np.array([e for _, e in ranges], np.int32)), torch.ones(K, dtype=torch.bool)]
    return bins, gh, args


def same_or_both_nan(a, b):
    """Bit-equal, NaN matching NaN whatever its sign and payload."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.masked_fill(a.isnan(), 0), b.masked_fill(b.isnan(), 0)))


@pytest.mark.parametrize("snapped", [True, False], ids=["snapped", "real"])
def test_ragged_histogram_nonfinite_stays_in_its_bins(cuda, snapped):
    """NaN, +inf and -inf in a few rows of one range: the kernel gives the
    plain fixed-point emulation's bits (NaN for NaN), so each such value makes
    only its own cells NaN or inf, as the plain version's float32 sum does
    (equal to it on snapped gradients, within the summation bound elsewhere
    otherwise); two launches bit-equal; the other range's columns equal a
    launch over that range alone."""
    from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_ragged_fixed,
                                                  fixed_point_exponents)

    N, G, B = 60000, 5, 64
    bins, gh, args_h = nonfinite_case(3, N, G, B, [(1000, 21000), (30000, 59000)], snapped)
    t = torch.from_numpy
    b_d, g_d = t(bins).to(cuda), t(gh).to(cuda)
    args_d = [a.to(cuda) for a in args_h]
    got = hist_cuda.histogram_ragged(b_d, g_d, *args_d, B, 2)
    again = hist_cuda.histogram_ragged(b_d, g_d, *args_d, B, 2)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    exps = fixed_point_exponents(t(gh), N)
    assert torch.equal(fixed_point_exponents(g_d, N).cpu(), exps)
    got = got.cpu()
    assert same_or_both_nan(got, _histogram_slots_ragged_fixed(t(bins), t(gh), *args_h, B, 2,
                                                               exps))
    plain = _histogram_slots_ragged_plain(t(bins), t(gh), *args_h, B, 2)
    assert bool((~torch.isfinite(plain)).any())
    if snapped:
        assert same_or_both_nan(got, plain)
    else:
        fin = torch.isfinite(plain)
        assert same_or_both_nan(got[~fin], plain[~fin])
        clean = t(np.where(np.isfinite(gh), np.abs(gh), 0).astype(np.float32))
        bound = N * 2.0 ** -24 * _histogram_slots_ragged_plain(t(bins), clean, *args_h, B, 2)
        assert bool(((got - plain).abs()[fin].double() <= bound[fin].double()).all())
    one = [a[1:2].contiguous() for a in args_d[1:]]
    slot_1 = torch.where(args_d[0] == 1, 0, 1).to(torch.int32)
    alone = hist_cuda.histogram_ragged(b_d, g_d, slot_1, *one, B, 1)
    assert torch.equal(alone.cpu(), got[:, :, 3:6])


def test_histogram_slots_kernel_matches_plain(cuda):
    from lightgbm_tpu_torch.ops.histogram import histogram_slots

    rng = np.random.RandomState(3)
    G, N, B, S = 6, 20000, 255, 5
    bins = torch.from_numpy(rng.randint(0, B, size=(G, N)).astype(np.uint8))
    gh = torch.from_numpy((np.round(rng.normal(size=(N, 3)) * 16) / 16).astype(np.float32))
    slot = torch.from_numpy(rng.randint(0, S + 2, size=N).astype(np.int32))
    got = histogram_slots(bins.to(cuda), gh.to(cuda), slot.to(cuda), B, S)
    assert torch.equal(got.cpu(), histogram_slots(bins, gh, slot, B, S))


@pytest.mark.parametrize("n", [1, 1000, 300001])
def test_compact_kernel_matches_plain(cuda, n):
    from lightgbm_tpu_torch.ops.compact import range_partition_dst_by_range

    rng = np.random.RandomState(n)
    G = 28
    bins = torch.from_numpy(rng.randint(0, 256, size=(G, n)).astype(np.uint8))
    rows = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
    rows[0, 1] = float("nan")
    rows[-1, 0] = -0.0
    K = min(21, n)
    cuts = np.sort(rng.choice(n + 1, 2 * K, replace=True)).reshape(K, 2)
    starts, counts = torch.from_numpy(cuts[:, 0].astype(np.int32)), \
        torch.from_numpy((cuts[:, 1] - cuts[:, 0]).astype(np.int32))
    rng_of = np.full(n, K, np.int32)
    for k, (s, e) in enumerate(cuts):
        rng_of[s:e] = k
    go_left = torch.from_numpy(rng.rand(n) < 0.5)
    dst, _ = range_partition_dst_by_range(go_left, torch.from_numpy(rng_of), starts,
                                          counts, torch.ones(K, dtype=torch.bool))
    before = compact_cuda.launches["compact_rows"]
    d = [a.to(cuda) for a in (bins, rows, dst)]
    got = compact_cuda.compact(*d)
    again = compact_cuda.compact(*d)
    torch.cuda.synchronize()
    assert compact_cuda.launches["compact_rows"] == before + 2
    ref = _compact_rows_plain(bins, rows, dst)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g.cpu().view(torch.uint8), r.view(torch.uint8))
        assert torch.equal(a.cpu().view(torch.uint8), r.view(torch.uint8))


def test_compact_wrapper_rejects_bad_input(cuda):
    bins = torch.zeros((2, 100), dtype=torch.uint8, device=cuda)
    rows = torch.zeros((100, 5), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        compact_cuda.compact(bins, rows, torch.arange(100, device=cuda))
    dst = torch.arange(100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="alias"):
        compact_cuda.compact(bins, rows, dst, out=(bins, torch.empty_like(rows)))


def test_batched_split_scan_matches_one_leaf_launches(cuda):
    ds, B, hist, tot = _leaf_case(5, True)
    meta_d = ts.make_feature_meta(ds, B, cuda)
    meta_h = ts.make_feature_meta(ds, B, "cpu")
    params = torch.tensor(PARAMS, device=cuda)
    # six leaves: the leaf, halves and thirds of it (a wave's children)
    hists = torch.stack([hist, hist / 2, hist - hist / 2, hist / 3, hist * 0.25,
                         hist - hist / 3])
    totals = hists[:, 0].sum(dim=1)
    fh = ts.gather_feature_hist(hists, meta_d, totals)
    before = scan_cuda.launches["split_scan_batched"]
    recs = scan_cuda.split_scan(fh, totals, meta_d, params)
    assert scan_cuda.launches["split_scan_batched"] == before + 1
    assert recs.shape == (6, len(meta_h.real_feature), 14)
    ref = ts.per_feature_best(fh.cpu(), totals.cpu(), meta_h, torch.tensor(PARAMS))
    assert torch.equal(recs[..., 1:].cpu(), ref[..., 1:])
    for i in range(6):
        one = scan_cuda.split_scan(fh[i].contiguous(), totals[i].contiguous(), meta_d,
                                   params)
        assert torch.equal(recs[i].view(torch.int32), one.view(torch.int32))


def _wave_card_vs_cpu(params):
    rng = np.random.RandomState(12)
    X = rng.normal(size=(20000, 10))
    y = (X[:, 0] + X[:, 3] > 0).astype(np.float64)
    params = {"objective": _snapped_logloss, "num_leaves": 63, "verbosity": -1, **params}
    counts = {name: dict(launches) for name, launches in
              (("hist", hist_cuda.launches), ("part", compact_cuda.wave_launches),
               ("scan", scan_cuda.launches))}
    card = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=3)
    assert isinstance(card._gbdt.tree_learner, DeviceTreeLearner)
    assert hist_cuda.launches["histogram_slots_ragged_image"] > \
        counts["hist"]["histogram_slots_ragged_image"]
    for name in ("partition_decide", "partition_scan", "partition_scatter", "relabel_rows"):
        assert compact_cuda.wave_launches[name] > counts["part"][name]
    assert scan_cuda.launches["find_best_split_batched"] > \
        counts["scan"]["find_best_split_batched"]
    host_params = {**params, "objective": "none", "device_type": "cpu",
                   "num_iterations": 3}
    train = lt.Dataset(X, label=y)
    host = lt.Booster(params=host_params, train_set=train)
    host._gbdt.tree_learner = DeviceTreeLearner(host._gbdt.config, train._handle,
                                                torch.device("cpu"))
    for _ in range(3):
        host.update(fobj=_snapped_logloss)
    assert card.model_to_string() == host.model_to_string()


def test_wave_learner_on_card_byte_equal_to_cpu(cuda):
    _wave_card_vs_cpu({"bagging_fraction": 0.8, "bagging_freq": 1})


def test_wave_learner_on_card_byte_equal_to_cpu_without_bagging(cuda):
    _wave_card_vs_cpu({})


@pytest.mark.parametrize("n", [3000, 300001])
@pytest.mark.parametrize("case_args", WAVE_CASES, ids=[c[0] for c in WAVE_CASES])
def test_partition_kernel_matches_plain(cuda, case_args, n):
    from lightgbm_tpu_torch.ops.compact import partition_wave, relabel_rows

    name, n_leaves, K, n_invalid, order, form = case_args
    case = wave_case(n + K, n_leaves, K, n_invalid, order, form, N=n, G=28)
    bins, row = torch.from_numpy(case["bins"]), torch.from_numpy(case["row"])
    args = partition_inputs(case)
    row_d = row.to(cuda)
    if "relabel" in case:
        table = torch.from_numpy(case["relabel"])
        before = compact_cuda.wave_launches["relabel_rows"]
        relabel_rows(row, 4, table)
        relabel_rows(row_d, 4, table.to(cuda))
        assert compact_cuda.wave_launches["relabel_rows"] == before + 1
        assert torch.equal(row_d.cpu().view(torch.int32), row.view(torch.int32))

    def run(device):
        slot = torch.full((n,), -7, dtype=torch.int32, device=device)
        got = partition_wave(bins.to(device), row if device == "cpu" else row_d, 4,
                             *[None if a is None else a.to(device) for a in args],
                             bagged=form == "bagged", slot_out=slot)
        return [t.cpu() for t in got] + [slot.cpu()]

    before = dict(compact_cuda.wave_launches)
    got, again = run(cuda), run(cuda)
    for kernel in ("partition_decide", "partition_scan", "partition_scatter"):
        assert compact_cuda.wave_launches[kernel] == before[kernel] + 2
    ref = run("cpu")
    for g, a, r in zip(got, again, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g.view(torch.uint8), r.view(torch.uint8))
        assert torch.equal(a.view(torch.uint8), r.view(torch.uint8))


def test_partition_rows_of_no_leaf_stay_put(cuda):
    """Rows whose leaf-id column holds no leaf id (NaN, +-3e38, values just
    outside the table) belong to no range: the kernel moves them nowhere and
    reads nothing through them, as the plain version does."""
    from lightgbm_tpu_torch.ops.compact import partition_wave

    case = wave_case(5, 12, 4, 0, "shuffled", "wave", N=300001, G=28)
    row = case["row"].copy()
    tail = np.nonzero(row[:, 4] == -1)[0]
    n2 = case["leaf2k"].shape[0]
    junk = np.array([np.nan, 3.4e38, -1.7e38, -2.0, n2 - 1.0, 2.0 ** 31, -(2.0 ** 31), np.inf,
                     -np.inf], np.float32)
    row[tail[:len(junk) * 50], 4] = np.tile(junk, 50)
    args = partition_inputs(case)
    out = {}
    for device in ("cpu", cuda):
        got = partition_wave(torch.from_numpy(case["bins"]).to(device),
                             torch.from_numpy(row).to(device), 4,
                             *[a.to(device) for a in args])
        out[str(device)] = [t.cpu() for t in got]
    for g, r in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(g.view(torch.uint8), r.view(torch.uint8))
    assert torch.equal(out["cpu"][1][tail].view(torch.int32),
                       torch.from_numpy(row[tail]).view(torch.int32))


def test_partition_wrapper_rejects_bad_input(cuda):
    from lightgbm_tpu_torch.ops.compact import partition_wave

    bins = torch.zeros((2, 100), dtype=torch.uint8, device=cuda)
    rows = torch.zeros((100, 5), device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="alias"):
        partition_wave(bins, rows, 4, None, None, None, 0 * one, 100 * one, one,
                       bagged=True, out=(bins, torch.empty_like(rows)))
    with pytest.raises(ValueError, match="one range"):
        partition_wave(bins, rows, 4, None, None, None, one.repeat(2), one.repeat(2),
                       one.repeat(2), bagged=True)
    with pytest.raises(ValueError, match="int32"):
        partition_wave(bins, rows, 4, None, None, None, 0 * one, 100 * one, one.bool(),
                       bagged=True)


def _bundled_case(seed):
    """A dataset whose sparse features EFB bundles, one leaf's histogram
    (from the kernel) and its totals on the card."""
    rng = np.random.RandomState(seed)
    n = 20000
    X = np.where(rng.rand(n, 12) < 0.01, rng.normal(size=(n, 12)), 0.0)
    ds = Dataset.from_matrix(X, label=np.zeros(n), config=Config({"min_data_in_leaf": 5}))
    assert any(g.is_multi for g in ds.groups)
    B = int(max(ds.group_bin_counts().max(), 2))
    gh = np.stack([rng.normal(size=n), rng.uniform(0.05, 0.5, size=n), np.ones(n)], 1)
    gh = np.concatenate([gh, np.zeros((1, 3))]).astype(np.float32)
    idx = np.full(16384, n, np.int32)
    idx[:12000] = np.sort(rng.choice(n, 12000, replace=False))
    hist = hist_cuda.histogram(torch.from_numpy(ds.bins).to("cuda"),
                               torch.from_numpy(gh).to("cuda"),
                               torch.from_numpy(idx).to("cuda"), B)
    return ds, B, hist, hist[0].sum(dim=0)


@pytest.mark.parametrize("leaves", [1, 6])
@pytest.mark.parametrize("mask", ["none", "sampled", "penalty"])
@pytest.mark.parametrize("data", ["nan", "zero", "bundled"])
def test_find_best_split_kernel_matches_plain_on_cpu(cuda, leaves, mask, data):
    if data == "bundled":
        ds, B, hist, tot = _bundled_case(9)
    else:
        ds, B, hist, tot = _leaf_case(3, data == "nan")
    meta_d = ts.make_feature_meta(ds, B, cuda)
    meta_h = ts.make_feature_meta(ds, B, "cpu")
    F = len(meta_h.real_feature)
    rng = np.random.RandomState(7)
    fmask = None if mask == "none" else rng.rand(F) < 0.7
    pen = rng.uniform(0, 3, size=F).astype(np.float32) if mask == "penalty" else None
    if leaves > 1:  # a wave's children: the leaf, parts of it, their rests
        hist = torch.stack([hist, hist / 2, hist - hist / 2, hist / 3, hist * 0.25,
                            hist - hist / 3])
        tot = hist[:, 0].sum(dim=1)
    params = torch.tensor(PARAMS)
    name = "find_best_split_batched" if leaves > 1 else "find_best_split"
    before = scan_cuda.launches[name]
    dev_args = (None if fmask is None else torch.from_numpy(fmask).to(cuda),
                None if pen is None else torch.from_numpy(pen).to(cuda))
    rec = ts.find_best_split(hist, tot, meta_d, params.to(cuda), *dev_args).cpu()
    assert scan_cuda.launches[name] == before + 1
    host_args = (None if fmask is None else torch.from_numpy(fmask),
                 None if pen is None else torch.from_numpy(pen))
    ref = ts.find_best_split(hist.cpu(), tot.cpu(), meta_h, params, *host_args)
    assert torch.equal(rec[..., 1:], ref[..., 1:])
    finite = torch.isfinite(ref[..., 0])
    assert torch.equal(torch.isfinite(rec[..., 0]), finite)
    shift = ts.leaf_gain(tot[..., 0].cpu(), tot[..., 1].cpu(), *params[[0, 1, 5]])
    ulp = np.spacing(np.abs((ref[..., 0] + shift).numpy()).astype(np.float32))
    assert (np.abs((rec[..., 0] - ref[..., 0]).numpy())[finite.numpy()]
            <= 4 * ulp[finite.numpy()]).all()
    assert (rec[..., 1] >= 0).any()  # some leaf has a split to compare
    # the per-feature launch and the argmax give the same bits
    fh = ts.gather_feature_hist(hist, meta_d, tot)
    per = ts.reduce_best_record(scan_cuda.split_scan(fh, tot, meta_d, params.to(cuda),
                                                     *dev_args))
    assert torch.equal(per.cpu().view(torch.int32), rec.view(torch.int32))
    if leaves == 1:  # host totals go by value, with the same bits
        by_value = ts.find_best_split(hist, tot.cpu().tolist(), meta_d, params.to(cuda),
                                      *dev_args)
        assert torch.equal(by_value.cpu().view(torch.int32), rec.view(torch.int32))


# (N, P, count, table): the root of a few tiles with a random table, a leaf
# read to its count through half a bucket of padding, a row set of one
# partial tile, every row left, every row right, no rows; one row, a warp,
# 1,023, 1,024 and 1,025 rows (tiles of 1,024 positions), 4,095, 4,096 and
# 4,097, padding past several tiles, the main path's root (1,048,576 rows in
# 256 tiles of 4,096: one look-back window) and a count one short of it,
# 2,000,000 rows (489 tiles: two windows), and both sides of the tile
# size's switch at 2**18 positions
ROW_SPLITS = [(300001, 524288, 300001, "random"), (300001, 262144, 140001, "random"),
              (5000, 1024, 700, "random"), (5000, 4096, 3000, "left"),
              (5000, 4096, 3000, "right"), (5000, 256, 0, "random"),
              (5000, 256, 1, "random"), (5000, 256, 31, "random"), (5000, 256, 32, "random"),
              (5000, 1024, 1023, "random"), (5000, 1024, 1024, "random"),
              (5000, 2048, 1025, "random"), (5000, 8192, 1025, "left"),
              (1048576, 1048576, 1048576, "random"), (1048576, 1048576, 1048575, "right"),
              (5000, 4096, 0, "random"), (300001, 8192, 4095, "random"),
              (300001, 8192, 4096, "random"), (300001, 8192, 4097, "random"),
              (300001, 65536, 4097, "left"), (2100000, 1 << 21, 2000000, "random"),
              (300001, 1 << 18, 262144, "random"), (300001, 524288, 262145, "right")]


@pytest.mark.parametrize("case", ROW_SPLITS, ids=[f"{c[2]}of{c[1]}-{c[3]}" for c in ROW_SPLITS])
def test_row_partition_kernels_match_plain(cuda, case):
    """The single-pass kernel against `_split_rows_plain` run on the CPU:
    both children's buffers and the left count exactly equal, two launches
    equal, one launch a call."""
    N, P, count, kind = case
    rng = np.random.RandomState(N + P + count)
    bins_row = rng.randint(0, 256, size=N).astype(np.uint8)
    idx = np.full(P, N, np.int32)
    idx[:count] = np.sort(rng.choice(N, count, replace=False))
    table = {"random": rng.rand(256) < 0.5, "left": np.ones(256, bool),
             "right": np.zeros(256, bool)}[kind]
    ref = _split_rows_plain(torch.from_numpy(bins_row), torch.from_numpy(idx), count, table, N)
    b_d, i_d = torch.from_numpy(bins_row).to(cuda), torch.from_numpy(idx).to(cuda)
    before = dict(partition_cuda.launches)
    got = partition_cuda.split_rows(b_d, i_d, count, table, N)
    again = partition_cuda.split_rows(b_d, i_d, count, table, N)
    torch.cuda.synchronize()
    assert partition_cuda.launches["row_partition"] == before["row_partition"] + 2
    for g, a, r in zip(got, again, ref):
        assert g.dtype == r.dtype == torch.int32 and g.shape == r.shape
        assert torch.equal(g.cpu(), r) and torch.equal(a.cpu(), r)


@pytest.mark.parametrize("bagged", [False, True], ids=["all_rows", "bagged"])
def test_row_partition_on_card_matches_cpu(cuda, bagged):
    """A tree's worth of splits through RowPartition on the card and on the
    CPU: the same counts and index sets after every split."""
    rng = np.random.RandomState(17 + bagged)
    n = 200000
    plane = rng.randint(0, 64, size=(5, n)).astype(np.uint8)
    card, host = RowPartition(n, cuda), RowPartition(n, "cpu")
    if bagged:
        bag = np.sort(rng.choice(n, 150000, replace=False)).astype(np.int32)
        card.set_used_indices(bag)
        host.set_used_indices(bag)
    plane_d = torch.from_numpy(plane).to(cuda)
    for leaf_new in range(1, 40):
        counts = {leaf: host.count(leaf) for leaf in range(leaf_new)}
        leaf = max(counts, key=counts.get) if leaf_new % 3 else int(rng.randint(0, leaf_new))
        g = int(rng.randint(0, 5))
        decision = (float(rng.randint(0, 63)), float(rng.rand() < 0.5),
                    float(rng.randint(0, 3)), float(rng.randint(0, 64)), 64.0, 0.0, 0.0, 0.0)
        assert go_left_table(decision).shape == (256,)
        got = card.split(leaf, leaf_new, plane_d[g], decision)
        assert got == host.split(leaf, leaf_new, torch.from_numpy(plane[g]), decision)
        for child in (leaf, leaf_new):
            assert torch.equal(card.indices(child).cpu(), host.indices(child))


def test_row_partition_on_two_streams_at_once(cuda):
    """Two threads partition on two streams at once, each on its own state
    buffer: every split equals the plain version."""
    import threading

    rng = np.random.RandomState(23)
    N, P = 300000, 262144
    bins_row = rng.randint(0, 256, size=N).astype(np.uint8)
    b_d = torch.from_numpy(bins_row).to(cuda)
    cases = []
    for k in range(2):
        count = 200000 + 1000 * k
        idx = np.full(P, N, np.int32)
        idx[:count] = np.sort(rng.choice(N, count, replace=False))
        table = rng.rand(256) < 0.5
        cases.append((torch.from_numpy(idx).to(cuda), count, table,
                      _split_rows_plain(torch.from_numpy(bins_row), torch.from_numpy(idx),
                                        count, table, N)))
    failures = []

    def work(k):
        i_d, count, table, ref = cases[k]
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(20):
                got = partition_cuda.split_rows(b_d, i_d, count, table, N)
                torch.cuda.current_stream().synchronize()
                if not all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)):
                    failures.append(k)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert failures == []


def test_row_partition_wrapper_rejects_bad_input(cuda):
    row = torch.zeros(100, dtype=torch.uint8, device=cuda)
    idx = torch.zeros(256, dtype=torch.int32, device=cuda)
    table = np.ones(256, bool)
    with pytest.raises(ValueError, match="uint8"):
        partition_cuda.split_rows(row.int(), idx, 10, table, 100)
    with pytest.raises(ValueError, match="int32"):
        partition_cuda.split_rows(row, idx.long(), 10, table, 100)
    with pytest.raises(ValueError, match="count"):
        partition_cuda.split_rows(row, idx, 300, table, 100)


@pytest.mark.parametrize("done", [False, True], ids=["live", "done"])
@pytest.mark.parametrize("K", [1, 4, 21])
def test_wave_step_kernels_match_plain(cuda, K, done):
    """select_wave and replay_wave: the kernels on the card against the
    plain versions on the CPU, on a random state: every output exactly
    equal, one launch each."""
    rng = np.random.RandomState(K * 3 + done)
    L = 63
    st = wave_state(rng, L, int(rng.randint(max(2, K), L // 2)))
    st["scalars"][DONE] = int(done)
    tables = [torch.from_numpy(a) for a in wave_tables_random(rng, 6)]
    plain_table = select_wave(*(torch.from_numpy(st[k].copy()) for k in
                                ("leaf_best", "start", "count", "scalars")),
                              FeatureTables(*tables), K)
    sel, ok = split_select(plain_table, L, K)[5].numpy(), split_select(plain_table, L, K)[4]
    recs2, totals2, nl = wave_children(rng, st, sel, ok.numpy() != 0)
    totals2[:2, 0] = (2.25, -2.25)  # a zero parent gradient: the output's sign bit
    totals2[-2:, 0] = (-0.0, -0.0) if K > 1 else totals2[-2:, 0]
    params = torch.tensor([0.0, 0.5, 5.0, 1e-3, 0.0, 0.4])
    out = {}
    for device in ("cpu", cuda):
        s = {k: torch.from_numpy(v.copy()).to(device) for k, v in st.items()}
        before = {k: wave_cuda.launches[k] for k in ("wave_select", "wave_replay")}
        table = select_wave(s["leaf_best"], s["start"], s["count"], s["scalars"],
                            FeatureTables(*(t.to(device) for t in tables)), K)
        table_in = table.clone()
        commit = replay_wave(s["leaf_best"], s["depth"], s["rec_store"], s["start"],
                             s["count"], s["scalars"], table,
                             torch.from_numpy(nl).to(device), torch.from_numpy(recs2).to(device),
                             torch.from_numpy(totals2).to(device), params.to(device), 4)
        grew = {k: wave_cuda.launches[k] - before[k] for k in before}
        assert grew == ({"wave_select": 1, "wave_replay": 1} if device == cuda
                        else {"wave_select": 0, "wave_replay": 0})
        out[str(device)] = ([table_in.cpu(), commit.cpu()]
                            + [s[k].cpu() for k in sorted(s)])
    for g, r in zip(out[str(cuda)], out["cpu"]):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g.view(torch.uint8), r.view(torch.uint8))


def _grow_case(device, K, bagged, masked, n=20000, L=63):
    rng = np.random.RandomState(19)
    X = rng.normal(size=(n, 10))
    X[rng.rand(n, 10) < 0.05] = np.nan
    y = (X[:, 0] + X[:, 3] > 0).astype(np.float64)
    cfg = Config({"objective": "binary", "num_leaves": L, "min_data_in_leaf": 5,
                  "verbosity": -1})
    learner = DeviceTreeLearner(cfg, Dataset.from_matrix(X, label=y, config=cfg),
                                torch.device(device))
    g = np.round(rng.normal(0, 0.4, n) * 16) / 16
    h = np.round(rng.uniform(0.0625, 0.25, n) * 16) / 16
    out = rng.rand(n) < 0.3
    leaf0 = np.where(out & bagged, -1, 0).astype(np.int32)
    gh = np.stack([g, h, np.ones(n)], 1).astype(np.float32)
    gh[leaf0 < 0] = 0.0
    fmask = torch.from_numpy(rng.rand(len(learner.meta.real_feature)) < 0.7) if masked \
        else None

    def grow():
        return _grow(learner.bins_dev, torch.from_numpy(gh).to(device),
                     torch.from_numpy(leaf0).to(device), learner.meta, learner.tables,
                     learner.params_dev, None if fmask is None else fmask.to(device), L,
                     learner.group_bin_padded, learner.config.max_depth, K, bagged,
                     learner._buffers)

    return grow


@pytest.mark.parametrize("case", [(1, False, False), (4, True, False), (21, False, True),
                                  (21, True, True)],
                         ids=["k1", "k4-bagged", "k21-masked", "k21-bagged-masked"])
def test_graphed_grower_byte_equal_to_cpu(cuda, case):
    """The wave learner's tree on the card (the tree's state on the card,
    the whole tree one CUDA graph launch: the root's graph, then a WHILE
    node whose body is two wave graphs; one copy of the results) against
    the same tree grown on the CPU: the split log's bytes, leaf ids, leaf
    count, rows histogrammed and waves equal; the results count every
    kernel the tree graph ran, and a second tree reuses the graphs."""
    K, bagged, masked = case
    host_tree = _grow_case("cpu", K, bagged, masked)()
    host = host_tree.result()
    grow = _grow_case(cuda, K, bagged, masked)
    first = grow()  # warm-up, captures
    buf = first.buffers
    assert (len(buf.graphs), len(buf.roots), len(buf.trees)) == (2, 1, 1) and first.graphed
    for grown in (first, None):
        before = ({k: dict(lib.launches) for k, lib in
                   (("wave", wave_cuda.LIB), ("part", compact_cuda.WAVE_LIB),
                    ("hist", hist_cuda.LIB), ("scan", scan_cuda.LIB))})
        second = grown is None
        if second:
            grown = grow()
            assert (len(buf.graphs), len(buf.roots), len(buf.trees)) == (2, 1, 1)
        rec, n_cur, hist_rows, n_waves = grown.result()
        n = grown.waves_launched
        if second:
            for name in ("wave_select", "wave_replay"):
                assert wave_cuda.launches[name] - before["wave"][name] == n
            # the condition kernel once, after the root: a pass's condition
            # is set by its second wave's replay
            assert wave_cuda.launches["tree_loop_cond"] - \
                before["wave"]["tree_loop_cond"] == 1
            for name in ("partition_decide", "partition_scan", "partition_scatter",
                         "relabel_rows"):
                assert compact_cuda.wave_launches[name] - before["part"][name] == \
                    n + (1 if bagged and name != "relabel_rows" else 0)
            assert hist_cuda.launches["histogram_slots_ragged_image"] - \
                before["hist"]["histogram_slots_ragged_image"] == n + 1
            assert scan_cuda.launches["find_best_split_batched"] - \
                before["scan"]["find_best_split_batched"] == n
            assert scan_cuda.launches["find_best_split"] - \
                before["scan"]["find_best_split"] == 1
        np.testing.assert_array_equal(rec.view(np.int32), host[0].view(np.int32))
        assert (n_cur, hist_rows, n_waves) == host[1:]
        assert n % 2 == 0 and n - n_waves in (0, 1)  # a pass is two waves
        assert n == host_tree.waves_launched
        assert torch.equal(grown.leaf_id.cpu(), host_tree.leaf_id)


def _eager_on_card(monkeypatch):
    """Grow on the card with the tree loop driven from the host (the CPU's
    loop, each pass reading the done word) in place of the tree graph."""
    from lightgbm_tpu_torch.treelearner import device as dmod

    class Eager:
        def __init__(self, buf, bagged, num_leaves, root, wave):
            self.args = (buf, 1 if bagged else 0, wave, num_leaves)
            self.root = root

        def launch(self):
            self.root()
            dmod._waves_eager(*self.args)

    monkeypatch.setattr(dmod, "_tree_graph", lambda buf, K, masked, bagged, L, root, wave:
                        Eager(buf, bagged, L, root, wave))
    monkeypatch.setattr(dmod._Grown, "_count", lambda self, passes: None)


@pytest.mark.parametrize("case", [(21, False, False), (4, True, True)],
                         ids=["k21", "k4-bagged-masked"])
def test_tree_graph_equals_the_eager_loop_on_card(cuda, case, monkeypatch):
    """The tree graph's WHILE loop and the host-driven loop on the same
    inputs on the card: the split log's bytes, leaf ids, leaf count, rows
    histogrammed, live waves and passes equal."""
    K, bagged, masked = case
    graphed = _grow_case(cuda, K, bagged, masked)()
    graphed.result()
    _eager_on_card(monkeypatch)
    eager = _grow_case(cuda, K, bagged, masked)()
    assert not eager.buffers.trees
    for a, b in zip(graphed.result(), eager.result()):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        else:
            assert a == b
    assert graphed.waves_launched == eager.waves_launched
    assert torch.equal(graphed.leaf_id, eager.leaf_id)


def test_reused_buffers_capture_a_new_tree_graph(cuda):
    """Buffers reused at a new width, then with a feature mask: each new
    (K, mask, bag) captures its own tree graph (never replays a stale one)
    and grows the CPU's tree."""
    from lightgbm_tpu_torch.treelearner.device import _grow

    rng = np.random.RandomState(23)
    n, L = 20000, 63
    X = rng.normal(size=(n, 10))
    y = (X[:, 0] + X[:, 3] > 0).astype(np.float64)
    cfg = Config({"objective": "binary", "num_leaves": L, "min_data_in_leaf": 5,
                  "verbosity": -1})
    learners = {dev: DeviceTreeLearner(cfg, Dataset.from_matrix(X, label=y, config=cfg),
                                       torch.device(dev)) for dev in ("cpu", "cuda")}
    g = np.round(rng.normal(0, 0.4, n) * 16) / 16
    gh = np.stack([g, np.full(n, 0.25), np.ones(n)], 1).astype(np.float32)
    fmask = rng.rand(len(learners["cpu"].meta.real_feature)) < 0.6
    seen = []
    for K, masked in ((21, False), (4, False), (4, True), (21, False)):
        out = {}
        for dev, lr in learners.items():
            grown = _grow(lr.bins_dev, torch.from_numpy(gh).to(dev),
                          torch.zeros(n, dtype=torch.int32, device=dev), lr.meta, lr.tables,
                          lr.params_dev,
                          torch.from_numpy(fmask).to(dev) if masked else None, L,
                          lr.group_bin_padded, -1, K, False, lr._buffers)
            out[dev] = (grown.result(), grown.leaf_id.cpu())
        rec, rest = out["cuda"][0][0], out["cuda"][0][1:]
        np.testing.assert_array_equal(rec.view(np.int32), out["cpu"][0][0].view(np.int32))
        assert rest == out["cpu"][0][1:]
        assert torch.equal(out["cuda"][1], out["cpu"][1])
        seen.append(sorted(learners["cuda"]._buffers.trees))
    assert seen == [[(21, False, False)], [(4, False, False), (21, False, False)],
                    [(4, False, False), (4, True, False), (21, False, False)],
                    [(4, False, False), (4, True, False), (21, False, False)]]
    assert out["cuda"][0][0][:, 3].sum() > 1  # the masked trees split too


def test_train_async_returns_before_the_tree_is_done(cuda):
    """train_async enqueues the tree and returns: its results copy has not
    landed when it returns (a 255-leaf tree on 400,000 rows takes the card
    milliseconds); the second tree enqueued before the first is finalized
    leaves the first its own log."""
    rng = np.random.RandomState(29)
    n = 400_000
    X = rng.normal(size=(n, 28))
    y = (X[:, 0] + X[:, 3] - X[:, 5] > 0).astype(np.float64)
    cfg = Config({"objective": "binary", "num_leaves": 255, "verbosity": -1})
    ds = Dataset.from_matrix(X, label=y, config=cfg)
    learner = DeviceTreeLearner(cfg, ds, cuda)
    ghs = []
    for seed in (1, 2):
        r = np.random.RandomState(seed)
        gh = np.stack([r.normal(size=n), r.uniform(0.1, 0.3, n), np.ones(n)], 1)
        ghs.append(torch.from_numpy(np.concatenate([gh, np.zeros((1, 3))])
                                    .astype(np.float32)).to(cuda))
    alone = [learner.train(gh).to_string() for gh in ghs]  # captures; the trees alone
    torch.cuda.synchronize()
    first = learner.train_async(ghs[0])
    buf = first.grown.buffers
    assert not buf.result_events[first.grown.slot].query()
    second = learner.train_async(ghs[1])
    assert learner.finalize(first).to_string() == alone[0]
    assert learner.finalize(second).to_string() == alone[1]
    assert alone[0] != alone[1]


def _snapped_softmax(preds, dataset):
    p = np.exp(preds - preds.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    onehot = np.eye(preds.shape[1])[dataset.get_label().astype(int)]
    grad = np.round((p - onehot) * 16) / 16
    hess = np.round(np.maximum(1.5 * p * (1.0 - p), 1.0 / 16) * 16) / 16
    return grad.T.ravel(), hess.T.ravel()


@pytest.mark.parametrize("learner", ["wave", "serial"])
def test_multiclass_on_card_byte_equal_to_cpu(cuda, learner):
    """Three trees an iteration on snapped softmax gradients: the card's
    model text equals the CPU's, through the wave learner (against a CPU
    GBDT whose learner is the wave learner) and the serial learner
    (feature_fraction_bynode 0.8)."""
    rng = np.random.RandomState(31)
    X = rng.normal(size=(20000, 10))
    y = np.digitize(X[:, 0] + X[:, 3], [-0.5, 0.5]).astype(np.float64)
    params = {"objective": _snapped_softmax, "num_class": 3, "num_leaves": 31,
              "verbosity": -1}
    if learner == "serial":
        params["feature_fraction_bynode"] = 0.8
    card = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=3)
    assert isinstance(card._gbdt.tree_learner, DeviceTreeLearner) == (learner == "wave")
    if learner == "serial":
        host = lt.train({**params, "device_type": "cpu"}, lt.Dataset(X, label=y),
                        num_boost_round=3)
    else:
        train = lt.Dataset(X, label=y)
        host = lt.Booster(params={**params, "objective": "none", "device_type": "cpu",
                                  "num_iterations": 3}, train_set=train)
        host._gbdt.tree_learner = DeviceTreeLearner(host._gbdt.config, train._handle,
                                                    torch.device("cpu"))
        for _ in range(3):
            host.update(fobj=_snapped_softmax)
    assert card.num_trees() == 9
    assert card.model_to_string() == host.model_to_string()


def test_async_on_card_bit_identical_to_sync(cuda):
    """The pipeline on the card (learning rate 0.125, no metric, no valid
    set): trees pending across iterations, the train score from the split
    log; scores and model text bit-equal to the synchronous path's."""
    rng = np.random.RandomState(37)
    X = rng.normal(size=(50000, 12))
    y = (X[:, 0] - 0.7 * X[:, 1] + 0.3 * rng.normal(size=50000) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 63, "learning_rate": 0.125,
              "metric": "None", "verbosity": -1}
    out = []
    for asyn in (True, False):
        bst = lt.Booster(dict(params), lt.Dataset(X, label=y))
        bst._gbdt._async_pipeline = asyn
        pending = []
        for _ in range(6):
            bst.update()
            pending.append(bst._gbdt._pending is not None)
        assert pending == [False] + [asyn] * 5
        out.append((bst._gbdt.score.cpu(), bst.model_to_string()))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


QUANT_CASES = ["random", "const_hess", "zero", "boundary"]


def _quant_inputs(case, n, rng):
    g = (rng.normal(size=n) * 0.37).astype(np.float32)
    h = rng.uniform(0.01, 0.25, size=n).astype(np.float32)
    if case == "const_hess":
        h[:] = 0.25
    elif case == "zero":
        g[:] = 0.0
        h[:] = 0.0
    elif case == "boundary":  # values a few ULP from g * inv_g + 0.5 meeting an integer
        scale = np.float32(np.abs(g).max() / np.float32(2))
        k = rng.randint(-2, 2, size=n)
        g = (np.float32(k + 0.5) * scale).astype(np.float32)
        steps = rng.randint(-3, 4, size=n)
        g = np.where(steps < 0, np.nextafter(g, np.float32(-9)),
                     np.where(steps > 0, np.nextafter(g, np.float32(9)), g)).astype(np.float32)
        g = np.clip(g, -np.abs(g).max(), np.abs(g).max()).astype(np.float32)
    return g, h


@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("bins", [4, 16])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_quantize_kernel_matches_plain(cuda, case, bins, stochastic):
    """The discretizer's two launches against the plain version on the CPU,
    bit for bit: the int8 rows, the sentinel, both scales; from the strided
    gradient columns of an extended gradient array, as the learners pass
    them."""
    from lightgbm_tpu_torch.ops import quantize_cuda
    from lightgbm_tpu_torch.ops.quantize import _quantize_gh_plain, prng_key

    rng = np.random.RandomState(bins + 10 * stochastic)
    n = 300_001
    g, h = _quant_inputs(case, n, rng)
    ext = np.zeros((n + 1, 3), np.float32)
    ext[:n, 0], ext[:n, 1], ext[:n, 2] = g, h, 1.0
    e_d = torch.from_numpy(ext).to(cuda)
    for seed in (0, 77):
        key = prng_key(seed)
        before = dict(quantize_cuda.launches)
        gh, scale = quantize_cuda.quantize(e_d[:-1, 0], e_d[:-1, 1], key, bins, stochastic)
        again, _ = quantize_cuda.quantize(e_d[:-1, 0], e_d[:-1, 1], key, bins, stochastic)
        torch.cuda.synchronize()
        assert quantize_cuda.launches["quantize"] == before["quantize"] + 2
        assert quantize_cuda.launches["quantize_reduce"] == before["quantize_reduce"] + 2
        ref_gh, ref_scale = _quantize_gh_plain(torch.from_numpy(ext[:-1, 0]),
                                               torch.from_numpy(ext[:-1, 1]), key, bins,
                                               stochastic)
        assert torch.equal(gh, again)
        assert torch.equal(gh.cpu(), ref_gh)
        assert torch.equal(scale.cpu().view(torch.int32), ref_scale.view(torch.int32))


@pytest.mark.parametrize("leaves", [1, 6])
def test_find_best_split_int_kernel_matches_plain(cuda, leaves):
    """The split kernel's int32 mode: each value converted and scaled as it
    is loaded. Records bit-equal to the plain version (hist.float() *
    scale, then the float search) on the CPU, one leaf and a batch."""
    from lightgbm_tpu_torch.ops.histogram import build_histogram_rows
    from lightgbm_tpu_torch.ops.quantize import prng_key, quantize_gh

    rng = np.random.RandomState(41 + leaves)
    n = 30000
    X = rng.normal(size=(n, 9))
    X[rng.rand(n, 9) < 0.05] = np.nan
    ds = Dataset.from_matrix(X, label=np.zeros(n), config=Config({}))
    B = int(max(ds.group_bin_counts().max(), 2))
    meta_h = ts.make_feature_meta(ds, B, "cpu")
    meta_d = ts.make_feature_meta(ds, B, cuda)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.3, size=n).astype(np.float32))
    gh, scale = quantize_gh(g, h, prng_key(3), 4, True)
    hists = []
    for _ in range(leaves):
        rows = np.sort(rng.choice(n, int(rng.randint(500, n)), replace=False)).astype(np.int32)
        idx = np.concatenate([rows, np.full(64, n, np.int32)])
        hists.append(build_histogram_rows(torch.from_numpy(ds.bins), gh, torch.from_numpy(idx),
                                          B))
    hist = torch.stack(hists) if leaves > 1 else hists[0]
    tot = (hist[..., 0, :, :].sum(dim=-2).to(torch.float32) * scale)
    params = torch.tensor(PARAMS)
    ref = ts.find_best_split(hist, tot, meta_h, params, scale=scale)
    name = "find_best_split_batched_int" if leaves > 1 else "find_best_split_int"
    before = scan_cuda.launches[name]
    got = ts.find_best_split(hist.to(cuda), tot.to(cuda), meta_d, params.to(cuda),
                             scale=scale.to(cuda))
    torch.cuda.synchronize()
    assert scan_cuda.launches[name] == before + 1
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


def _host_logloss(preds, dataset):
    """The binary logloss gradients, unsnapped, computed on the host: the
    card's torch.exp differs from the CPU's in the last bit on a share of
    float32 inputs, so the built-in objective's gradients do too."""
    p = 1.0 / (1.0 + np.exp(-preds))
    label = dataset.get_label()
    return p - label, p * (1.0 - p)


def _quant_snapped_logloss(preds, dataset):
    p = 1.0 / (1.0 + np.exp(-preds))
    label = dataset.get_label()
    return (np.round((p - label) * 16) / 16,
            np.round(np.maximum(p * (1.0 - p), 1.0 / 16) * 16) / 16)


@pytest.mark.parametrize("renew", [False, True], ids=["renew_off", "renew_on"])
@pytest.mark.parametrize("learner", ["wave", "serial"])
def test_quantized_training_on_card_byte_equal_to_cpu(cuda, learner, renew):
    """Quantized training (stochastic rounding, 4 bins, a bag) on the card
    against the CPU: renewal off on the binary logloss gradients computed on
    the host, unsnapped, renewal on with snapped ones; model text
    byte-equal, through the
    wave learner (a CPU GBDT whose learner is the wave learner) and the
    serial learner (feature_fraction_bynode 0.8)."""
    rng = np.random.RandomState(43)
    X = rng.normal(size=(20000, 10))
    y = (X[:, 0] - 0.5 * X[:, 2] + 0.3 * rng.normal(size=20000) > 0).astype(np.float64)
    fobj = _quant_snapped_logloss if renew else _host_logloss
    params = {"objective": "none", "num_leaves": 31, "verbosity": -1,
              "use_quantized_grad": True, "quant_train_renew_leaf": renew,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    if learner == "serial":
        params["feature_fraction_bynode"] = 0.8
    texts = []
    for dev in ("cuda", "cpu"):
        train = lt.Dataset(X, label=y)
        bst = lt.Booster(params={**params, "device_type": dev}, train_set=train)
        if learner == "wave" and dev == "cpu":
            bst._gbdt.tree_learner = DeviceTreeLearner(bst._gbdt.config, train._handle,
                                                       torch.device("cpu"))
        assert isinstance(bst._gbdt.tree_learner, DeviceTreeLearner) == (learner == "wave")
        for _ in range(4):
            bst.update(fobj=fobj)
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1]


@pytest.mark.parametrize("C", [1, 3], ids=["binary", "3-class"])
def test_goss_selection_on_card_bit_equal_to_cpu(cuda, C):
    """GOSS's selection on the card: the bag mask and the rescaled g, h
    bit-equal to the same ops on the CPU, NaN and -0.0 included."""
    from lightgbm_tpu_torch.models.sample_strategy import goss_select

    rng = np.random.RandomState(7)
    n = 50000
    g = rng.choice(np.array([-0.5, -0.0, 0.0, 0.3, 1.5], np.float32), (C, n))
    g[rng.rand(C, n) < 0.01] = np.nan
    h = rng.uniform(0.1, 1.0, (C, n)).astype(np.float32)
    pos = torch.from_numpy(rng.permutation(n - 10000)[:5000].astype(np.int64))
    outs = [goss_select(torch.from_numpy(g).to(d), torch.from_numpy(h).to(d), pos.to(d),
                        8.0, 10000) for d in (cuda, torch.device("cpu"))]
    def bits(t):  # every NaN one pattern: the card's NaN * 8 is its own canonical NaN
        t = t.cpu()
        if not t.is_floating_point():
            return t
        return torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t).view(torch.int32)

    for a, b in zip(*outs):
        assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("learner", ["wave", "serial"])
def test_goss_training_on_card_byte_equal_to_cpu(cuda, learner):
    """GOSS on snapped gradients (the multiplier 8 keeps them snapped),
    learning rate 0.5 so rounds 3-6 sample: card and CPU model texts
    byte-equal, the wave learner's bag a mask on the card."""
    rng = np.random.RandomState(44)
    X = rng.normal(size=(20000, 10))
    y = (X[:, 0] - 0.5 * X[:, 2] + 0.3 * rng.normal(size=20000) > 0).astype(np.float64)
    params = {"objective": "none", "num_leaves": 31, "verbosity": -1, "learning_rate": 0.5,
              "data_sample_strategy": "goss"}
    if learner == "serial":
        params["feature_fraction_bynode"] = 0.8
    texts = []
    for dev in ("cuda", "cpu"):
        train = lt.Dataset(X, label=y)
        bst = lt.Booster(params={**params, "device_type": dev}, train_set=train)
        if learner == "wave" and dev == "cpu":
            bst._gbdt.tree_learner = DeviceTreeLearner(bst._gbdt.config, train._handle,
                                                       torch.device("cpu"))
        for _ in range(6):
            bst.update(fobj=_quant_snapped_logloss)
        texts.append(bst.model_to_string())
        assert bst._gbdt._cur_bag.mask.device.type == ("cuda" if dev == "cuda" else "cpu")
    assert texts[0] == texts[1]


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quantized"])
def test_categorical_training_on_card_byte_equal_to_cpu(cuda, quantized):
    """Categorical features through the serial learner on the card (the
    categorical scan a CUDA graph a shape): model text byte-equal to the
    CPU's, snapped gradients for the float mode and unsnapped ones for the
    quantized, with bagging; the train score equal to predict(raw_score)."""
    rng = np.random.RandomState(45)
    n = 20000
    cats = rng.randint(0, 40, n).astype(np.float64)
    cats[rng.rand(n) < 0.05] = np.nan
    X = np.column_stack([cats, rng.randint(0, 3, n), rng.normal(size=(n, 3))])
    effect = rng.normal(0, 1, 41)[np.nan_to_num(cats, nan=40).astype(int)]
    y = (effect + X[:, 2] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    params = {"objective": "none", "num_leaves": 31, "verbosity": -1,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    if quantized:
        params.update(use_quantized_grad=True, num_grad_quant_bins=4)
    fobj = _host_logloss if quantized else _quant_snapped_logloss
    texts = []
    for dev in ("cuda", "cpu"):
        bst = lt.Booster(params={**params, "device_type": dev},
                         train_set=lt.Dataset(X, label=y, categorical_feature=[0, 1]))
        for _ in range(4):
            bst.update(fobj=fobj)
        texts.append(bst.model_to_string())
        assert sum(t.num_cat for t in bst._gbdt.models) > 0
        gap = np.abs(bst._gbdt.score[0].cpu().numpy() - bst.predict(X, raw_score=True)).max()
        assert gap <= 1e-6, gap
    assert texts[0] == texts[1]


def _constraint_case(cuda, kind):
    """A leaf of `kind` ("nan", "zero" or "bundled") with mixed monotone
    constraints, its FeatureMeta on the card and on the host, and output
    bounds that bind its unconstrained record on both sides."""
    ds, B, hist, tot = _bundled_case(9) if kind == "bundled" else _leaf_case(3, kind == "nan")
    F = len(ds.used_features)
    ds.monotone_constraints = [(1, -1, 0)[f % 3] for f in range(ds.num_total_features)]
    meta_d, meta_h = ts.make_feature_meta(ds, B, cuda), ts.make_feature_meta(ds, B, "cpu")
    free = ts.find_best_split(hist.cpu(), tot.cpu(), meta_h, torch.tensor(PARAMS))
    mid = (float(free[10]) + float(free[11])) / 2
    half = abs(float(free[10]) - float(free[11])) / 2
    assert F > 0 and free[1] >= 0
    return ds, B, hist, tot, meta_d, meta_h, (mid - 0.75 * half, mid + 0.75 * half)


@pytest.mark.parametrize("bounds", ["binding", "infinite"])
@pytest.mark.parametrize("data", ["nan", "zero", "bundled"])
def test_constrained_find_best_split_kernel_matches_plain_on_cpu(cuda, data, bounds):
    """The split kernel's constrained mode (find form, float and integer
    input, and the per-feature form) against its plain version on the CPU:
    records bit-equal."""
    ds, B, hist, tot, meta_d, meta_h, bind = _constraint_case(cuda, data)
    c = bind if bounds == "binding" else (-float("inf"), float("inf"))
    params = torch.tensor(PARAMS)
    host_tot = tot.cpu().tolist()
    before = dict(scan_cuda.launches)
    rec = ts.find_best_split(hist, host_tot, meta_d, params.to(cuda), constraint=c).cpu()
    ref = ts.find_best_split(hist.cpu(), tot.cpu(), meta_h, params, constraint=c)
    assert torch.equal(rec.view(torch.int32), ref.view(torch.int32))
    if bounds == "infinite":
        assert rec[1] >= 0
    fh = ts.gather_feature_hist(hist, meta_d, tot)
    per = scan_cuda.split_scan(fh, tot, meta_d, params.to(cuda), constraint=c).cpu()
    per_ref = ts.per_feature_best(fh.cpu(), tot.cpu(), meta_h, params, constraint=c)
    assert torch.equal(per.view(torch.int32), per_ref.view(torch.int32))
    q = torch.round(hist / hist.abs().amax() * 1000).to(torch.int32)
    scale = torch.tensor([1e-3, 2e-3, 1.0], device=cuda)
    qtot = (q[0].sum(dim=0).to(torch.float32) * scale).cpu().tolist()
    rec_q = ts.find_best_split(q, qtot, meta_d, params.to(cuda), scale=scale, constraint=c).cpu()
    ref_q = ts.find_best_split(q.cpu(), qtot, meta_h, params, scale=scale.cpu(), constraint=c)
    assert torch.equal(rec_q.view(torch.int32), ref_q.view(torch.int32))
    for name in ("find_best_split_constrained", "find_best_split_constrained_int",
                 "split_scan_constrained"):
        assert scan_cuda.launches[name] == before[name] + 1, name
    with pytest.raises(ValueError, match="one leaf"):
        ts.find_best_split(torch.stack([hist, hist]), torch.stack([tot, tot]), meta_d,
                           params.to(cuda), constraint=c)


def _linear_data(seed, n):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, size=(n, 4))
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 1] + 1.0, -1.5 * X[:, 1]) + 0.5 * X[:, 2] \
        + 0.05 * rng.normal(size=n)
    X[::37, 1] = np.nan
    return X, y


def test_linear_predict_on_card_bit_equal_to_cpu(cuda):
    """A linear model's predict on the card: the traversal's leaf mode
    (counted) and the epilogue, bit-equal to the CPU's plain path."""
    from lightgbm_tpu_torch.ops import predict_cuda

    X, y = _linear_data(46, 20000)
    params = {"objective": "regression", "num_leaves": 31, "linear_tree": True,
              "linear_lambda": 0.01, "verbosity": -1}
    bst = lt.train({**params, "device_type": "cpu"}, lt.Dataset(X, label=y),
                   num_boost_round=6)
    text = bst.model_to_string()
    card = lt.Booster(model_str=text)
    host = lt.Booster(model_str=text, params={"device_type": "cpu"})
    leaf_before = predict_cuda.launches["predict_forest_leaf"]
    raw_before = predict_cuda.launches["predict_forest_raw"]
    Xt, _ = _linear_data(47, 70000)
    Xt[::53, 2] = np.inf
    got = card.predict(Xt, raw_score=True)
    assert predict_cuda.launches["predict_forest_leaf"] > leaf_before
    assert predict_cuda.launches["predict_forest_raw"] == raw_before
    assert np.array_equal(got, host.predict(Xt, raw_score=True))


LANES = [
    ({"monotone_constraints": [1, -1, 0, 0, 0, 1, 0, 0, 0, -1]}, "monotone"),
    ({"monotone_constraints": [1, -1, 0, 0, 0, 1, 0, 0, 0, -1], "use_quantized_grad": True,
      "num_grad_quant_bins": 4}, "monotone-quantized"),
    ({"interaction_constraints": "[0,1,2],[3,4,5,6],[7,8,9]",
      "feature_fraction_bynode": 0.8}, "interaction"),
    ({"cegb_penalty_split": 1e-4, "cegb_penalty_feature_coupled": [2.0] * 10,
      "cegb_penalty_feature_lazy": [0.002] * 10}, "cegb"),
    ({"linear_tree": True, "linear_lambda": 0.01}, "linear"),
    ({"forcedsplits_filename": "FORCED"}, "forced"),
]


@pytest.mark.parametrize("extra,what", LANES, ids=[w for _, w in LANES])
def test_constraint_lanes_on_card_byte_equal_to_cpu(cuda, tmp_path, extra, what):
    """Each lane of the serial learner on snapped gradients: card and CPU
    model texts byte-equal; a monotone search launches the constrained
    mode."""
    import json

    rng = np.random.RandomState(48)
    n = 20000
    X = rng.normal(size=(n, 10))
    X[rng.rand(n, 10) < 0.02] = np.nan
    y = (X[:, 0] - np.nan_to_num(X[:, 1]) + 0.5 * X[:, 5] * np.nan_to_num(X[:, 9])
         + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    if extra.get("forcedsplits_filename") == "FORCED":
        path = str(tmp_path / "forced.json")
        with open(path, "w") as fh:
            json.dump({"feature": 0, "threshold": 0.0, "left": {"feature": 5,
                                                                "threshold": 0.5}}, fh)
        extra = {"forcedsplits_filename": path}
    if what == "linear":
        X = np.nan_to_num(X, nan=0.5)
    params = {"objective": "none", "num_leaves": 31, "verbosity": -1, **extra}
    fobj = _host_logloss if what == "monotone-quantized" else _quant_snapped_logloss
    before = dict(scan_cuda.launches)
    texts = []
    for dev in ("cuda", "cpu"):
        bst = lt.Booster(params={**params, "device_type": dev}, train_set=lt.Dataset(X, label=y))
        for _ in range(3):
            bst.update(fobj=fobj)
        texts.append(bst.model_to_string())
        assert bst.num_trees() == 3
    assert texts[0] == texts[1]
    if what.startswith("monotone"):
        name = "find_best_split_constrained" + ("_int" if "quantized" in what else "")
        assert scan_cuda.launches[name] > before[name]


def _card_and_cpu_boosters(params, X, y, wave=True):
    """A Booster on the card and one on the CPU; with `wave` the CPU's
    learner is the wave learner, as the card's is."""
    out = []
    for dev in ("cuda", "cpu"):
        train = lt.Dataset(X, label=y)
        bst = lt.Booster(params={**params, "device_type": dev}, train_set=train)
        if wave and dev == "cpu":
            bst._gbdt.tree_learner = DeviceTreeLearner(bst._gbdt.config, train._handle,
                                                       torch.device("cpu"))
        assert isinstance(bst._gbdt.tree_learner, DeviceTreeLearner) == wave
        out.append(bst)
    return out


@pytest.mark.parametrize("mode", ["standard", "xgboost"])
def test_dart_on_card_byte_equal_to_cpu(cuda, mode):
    """DART on snapped custom gradients through the wave learner: the drops
    add earlier trees over every row by the bin-space traversal on the card;
    drop sets and model text equal to the CPU's."""
    rng = np.random.RandomState(45)
    X = rng.normal(size=(20000, 10))
    y = (X[:, 0] - 0.5 * X[:, 2] + 0.3 * rng.normal(size=20000) > 0).astype(np.float64)
    params = {"boosting": "dart", "objective": "none", "num_leaves": 31, "verbosity": -1,
              "drop_rate": 0.5, "skip_drop": 0.2, "learning_rate": 0.3,
              "xgboost_dart_mode": mode == "xgboost"}
    texts, drops = [], []
    for bst in _card_and_cpu_boosters(params, X, y):
        seen = []
        for _ in range(6):
            bst.update(fobj=_snapped_logloss)
            seen.append(list(bst._gbdt.drop_index))
        texts.append(bst.model_to_string())
        drops.append(seen)
    assert drops[0] == drops[1] and sum(len(d) for d in drops[0]) > 0
    assert texts[0] == texts[1]


def test_rf_on_card_byte_equal_to_cpu(cuda):
    """RF on L2 with labels on a 1/64 grid through the wave learner, bagging
    0.5: the constant gradients stay on the card, and the model text and the
    running-average train score equal the CPU's."""
    X, y = grid_regression(46, n=20000, f=10)
    params = {"boosting": "rf", "objective": "regression", "num_leaves": 31, "verbosity": -1,
              "bagging_fraction": 0.5, "bagging_freq": 1}
    card, cpu = _card_and_cpu_boosters(params, X, y)
    for bst in (card, cpu):
        for _ in range(5):
            bst.update()
    assert card._gbdt._fixed_grads.device.type == "cuda"
    assert card.model_to_string() == cpu.model_to_string()
    assert torch.equal(card._gbdt.score.cpu(), cpu._gbdt.score)


def test_checkpoint_resume_on_card_bit_identical(cuda, tmp_path):
    """A checkpoint taken while the async pipeline has a tree pending
    (learning rate 0.125) flushes it; the run resumed from it on the card
    is byte-equal to the uninterrupted run, its train score bit-equal."""
    from lightgbm_tpu_torch.checkpoint import checkpoint_callback, load_checkpoint

    rng = np.random.RandomState(47)
    X = rng.normal(size=(50000, 12))
    y = (X[:, 0] - 0.7 * X[:, 1] + 0.3 * rng.normal(size=50000) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 63, "learning_rate": 0.125,
              "metric": "None", "verbosity": -1}
    path = str(tmp_path / "ckpt.txt")
    cb = checkpoint_callback(lambda it: path if it == 5 else str(tmp_path / f"c{it}.txt"),
                             period=5)
    straight = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=10,
                        callbacks=[cb])
    state = load_checkpoint(path)
    assert state is not None and state.iteration == 5
    assert state.manifest["world"]["device_kinds"] == [torch.cuda.get_device_name(0)]
    resumed = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=10,
                       init_model=path)
    assert resumed._gbdt._async_enabled()
    assert resumed.model_to_string() == straight.model_to_string()
    assert torch.equal(resumed._gbdt.score, straight._gbdt.score)


def test_refit_leaf_sums_on_card_equal_plain(cuda):
    """Refit's leaf sums (ops/histogram.py:leaf_sums_fixed, exact in fixed
    point: an int64 scatter-add, whose order cannot change a bit) on the
    card equal the CPU's on random gradients, and a refit of an L2 model on
    the card (no transcendental in the gradients) equals the CPU's refit."""
    from lightgbm_tpu_torch.ops.histogram import leaf_sums_fixed

    rng = np.random.RandomState(48)
    n, L = 300000, 255
    gh = torch.from_numpy(np.stack([rng.normal(size=n), rng.uniform(0, 1, size=n)], 1)
                          .astype(np.float32))
    leaf = torch.from_numpy(rng.randint(0, L, size=n))
    want = leaf_sums_fixed(gh, None, leaf, L)
    got = leaf_sums_fixed(gh.to(cuda), None, leaf.to(cuda), L)
    assert torch.equal(got.cpu(), want)
    X, y = grid_regression(49, n=20000, f=10)
    params = {"objective": "regression", "num_leaves": 31, "verbosity": -1}
    text = lt.train({**params, "device_type": "cpu"}, lt.Dataset(X, label=y),
                    num_boost_round=5).model_to_string()
    X2, y2 = grid_regression(50, n=20000, f=10)
    refits = [lt.Booster(params={**params, "device_type": dev}, model_str=text)
              .refit(X2, y2, decay_rate=0.5).model_to_string() for dev in ("cuda", "cpu")]
    assert refits[0] == refits[1] != text


def _forest(rng, C):
    from lightgbm_tpu_torch.models.synthetic import random_model

    return random_model(rng, 10, 30, 31, num_class=C, cat_features=(4,),
                        objective="binary sigmoid:1" if C == 1 else f"multiclass num_class:{C}")


@pytest.mark.parametrize("rows", [64, 4096, 50000])
def test_predict_accumulate_kernel_matches_plain(cuda, rows):
    """A slice of the forest added onto running sums: both plans (trees
    split across blocks below 32,768 rows, every block walking all trees
    above), 3 classes, bit-equal to the plain version's chain of adds."""
    from lightgbm_tpu_torch.models.synthetic import make_rows
    from lightgbm_tpu_torch.ops import predict_cuda
    from lightgbm_tpu_torch.ops.predict import _predict_raw_fused, pack_ensemble

    rng = np.random.RandomState(49)
    model = _forest(rng, 3)
    X = torch.from_numpy(make_rows(rng, rows, 10, (4,)))
    init = torch.from_numpy(rng.normal(size=(rows, 3)).astype(np.float32))
    part = pack_ensemble(model.trees).tree_slice(9, 45)
    part_d = pack_ensemble(model.trees, device=cuda).tree_slice(9, 45)
    before = predict_cuda.launches["predict_forest_raw_acc"]
    got = predict_cuda.forest_raw(part_d, X.to(cuda), 3, out=init.to(cuda), accumulate=True)
    assert predict_cuda.launches["predict_forest_raw_acc"] == before + 1
    assert torch.equal(got.cpu(), _predict_raw_fused(part, X, 3, init))


@pytest.mark.parametrize("C", [1, 3], ids=["binary", "3-class"])
def test_early_stop_on_card_bit_equal_to_cpu(cuda, C):
    from lightgbm_tpu_torch.models.synthetic import make_rows
    from lightgbm_tpu_torch.ops.predict import pack_ensemble, predict_raw, predict_raw_early_stop

    rng = np.random.RandomState(50)
    model = _forest(rng, C)
    X = torch.from_numpy(make_rows(rng, 20000, 10, (4,)))
    packed, packed_d = pack_ensemble(model.trees), pack_ensemble(model.trees, device=cuda)
    for margin in (0.8, float("inf")):
        got = predict_raw_early_stop(packed_d, X.to(cuda), C, 5, margin)
        assert torch.equal(got.cpu(), predict_raw_early_stop(packed, X, C, 5, margin))
    assert torch.equal(got, predict_raw(packed_d, X.to(cuda), C))


def _rank_objectives(cuda, name, params, y, sizes, positions=None):
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.objectives import create_objective

    md = Metadata(len(y))
    md.set_label(y)
    md.set_query(sizes)
    if positions is not None:
        md.set_positions(positions)
    out = []
    for dev in (cuda, torch.device("cpu")):
        obj = create_objective(name, Config({"objective": name, **params}))
        obj.init(md, len(y), dev)
        out.append(obj)
    return out


RANK_CASES = [("lambdarank", {}, False), ("lambdarank", {"lambdarank_norm": False}, False),
              ("lambdarank", {"lambdarank_position_bias_regularization": 0.1}, True),
              ("rank_xendcg", {}, False)]


@pytest.mark.parametrize("name,params,position", RANK_CASES,
                         ids=["norm", "no_norm", "debiased", "xendcg"])
def test_ranking_gradients_on_card_match_cpu(cuda, name, params, position):
    """Three iterations on the card and on the CPU from the same scores
    (the card's exp, log and log2 are not the CPU's, and its sums run in
    another order)."""
    from lightgbm_tpu_torch.objectives.rank import xendcg_uniforms

    _, y, sizes = rank_data(51, n_queries=400)
    card, cpu = _rank_objectives(cuda, name, params, y, sizes,
                                 shown_positions(sizes) if position else None)
    rtol, atol = (1e-5, 1e-7) if name == "rank_xendcg" else (0.0, 1e-5)
    score = (np.random.RandomState(51).normal(size=len(y)) * 2).astype(np.float32)
    for _ in range(3):
        g, h = card.get_gradients(torch.from_numpy(score).to(cuda))
        rg, rh = cpu.get_gradients(torch.from_numpy(score))
        assert g.is_cuda and h.is_cuda
        np.testing.assert_allclose(g.cpu().numpy(), rg.numpy(), rtol=rtol, atol=atol)
        np.testing.assert_allclose(h.cpu().numpy(), rh.numpy(), rtol=rtol, atol=atol)
        score = score - rg.numpy()
    if name == "rank_xendcg":
        seeds = cpu.seeds(np.arange(300))
        assert torch.equal(xendcg_uniforms(seeds, 256, cuda).cpu(),
                           xendcg_uniforms(seeds, 256, torch.device("cpu")))


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_ranking_metrics_on_card_match_cpu(cuda, name):
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.metrics import create_metric

    _, y, sizes = rank_data(52, n_queries=400)
    md = Metadata(len(y))
    md.set_label(y)
    md.set_query(sizes)
    md.set_weights(np.random.RandomState(52).uniform(0.5, 2.0, size=len(y)))
    score = np.random.RandomState(53).randint(-3, 4, size=len(y)).astype(np.float32)
    vals = []
    for dev in (cuda, torch.device("cpu")):
        metric = create_metric(name, Config({"eval_at": [1, 3, 5, 10]}))
        metric.init(md, len(y), dev)
        vals.append(metric.eval(torch.from_numpy(score).to(dev), None))
    np.testing.assert_allclose(vals[0], vals[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("learner", ["wave", "serial"])
def test_lambdarank_on_card_byte_equal_to_cpu(cuda, learner):
    """Snapped lambdarank gradients computed on the host, 63 leaves, 3
    rounds: the card's model text equals the CPU's (the wave learner on the
    CPU swapped into the CPU booster's GBDT)."""
    X, y, sizes = rank_data(54, n_queries=400, n_features=10)
    params = {"objective": "none", "num_leaves": 63, "min_data_in_leaf": 10,
              "metric": "None", "verbosity": -1}
    if learner == "serial":
        params["feature_fraction_bynode"] = 0.8
    texts = []
    for where in ("card", "cpu"):
        ds = lt.Dataset(X, label=y, group=sizes)
        bst = lt.Booster({**params, **({"device_type": "cpu"} if where == "cpu" else {})}, ds)
        if where == "cpu" and learner == "wave":
            bst._gbdt.tree_learner = DeviceTreeLearner(bst._gbdt.config, ds._handle,
                                                       torch.device("cpu"))
        assert isinstance(bst._gbdt.tree_learner, DeviceTreeLearner) == (learner == "wave")
        fobj = SnappedLambdarank()
        for _ in range(3):
            bst.update(fobj=fobj)
        texts.append(bst.model_to_string())
    assert texts[0] == texts[1]


def test_xendcg_checkpoint_resume_on_card(cuda, tmp_path):
    """rank_xendcg through the wave learner on the card, a checkpoint after
    round 3 of 6: the resumed run continues the draws from iteration 4 and
    is byte-equal to the uninterrupted run."""
    from lightgbm_tpu_torch.checkpoint import checkpoint_callback, load_checkpoint

    X, y, sizes = rank_data(55, n_queries=400, n_features=10)
    params = {"objective": "rank_xendcg", "num_leaves": 31, "metric": "None",
              "verbosity": -1}
    cb = checkpoint_callback(lambda it: str(tmp_path / f"ckpt_{it}.txt"), period=3)
    straight = lt.train(dict(params), lt.Dataset(X, label=y, group=sizes), num_boost_round=6,
                        callbacks=[cb])
    assert isinstance(straight._gbdt.tree_learner, DeviceTreeLearner)
    path = str(tmp_path / "ckpt_3.txt")
    assert load_checkpoint(path).objective == {"iter": 3}
    resumed = lt.train(dict(params), lt.Dataset(X, label=y, group=sizes), num_boost_round=6,
                       init_model=path)
    assert resumed.model_to_string() == straight.model_to_string()
    assert torch.equal(resumed._gbdt.score, straight._gbdt.score)
