"""Prediction early stopping's block kernel (`ops/predict_cuda.py:
early_stop_block`, `csrc/predict_forest.cu` `lgbt_predict_early_stop`)
against its plain version run on the CPU.

Marked `gpu`: these need an NVIDIA card with nvcc, and skip elsewhere. Run
them on the card with `python -m pytest -m gpu --noconftest
tests/test_torch_cuda_early_stop.py`. Whether a card is present is decided
inside the fixture, never at import, so every test worker collects the same
tests.

Contracts: on the card the block's scores are bit-equal to the plain
version's (a NaN score is NaN in both: the card's adds return the canonical
NaN where the CPU's keep a NaN input's payload), its next list equals the
plain one as a set (the kernel appends a warp at a time, in no fixed
order), its count equal; two launches give the
same bits; each call is one launch, counted as predict_early_stop. Cases:
one class and three; margins 0, 4, inf and a negative one; an empty list;
every row stopping; a last block shorter than the round period; NaN and
+-inf in X; running scores meeting NaN, +-inf and ties in the top two;
X 16-byte aligned with 4F a multiple of 16 (vector loads), F odd, a view of
X off 16 bytes, X too wide to stage, a block too large to stage, a linear-
tree forest; and the main path's block (10 trees of 255 leaves, 262,144 x
28). A whole early-stopped predict on the card equals the CPU's bit for
bit with one launch a block.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from lightgbm_tpu_torch.ops import predict_cuda
from lightgbm_tpu_torch.ops.predict import pack_ensemble, predict_raw_early_stop

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _forest(C, iters, leaves, F, seed, cats=()):
    return random_model(np.random.RandomState(seed), F, iters, leaves, num_class=C,
                        cat_features=cats,
                        objective="binary sigmoid:1" if C == 1 else f"multiclass num_class:{C}")


def _block(cuda, packed, X, scores, C, margin, rows_in, count):
    """The kernel and the plain version on the same inputs: (card scores,
    card list, card count), (plain ...)."""
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = packed[dev.type]
        s = scores.clone().to(dev)
        counts = torch.tensor([count, 0], dtype=torch.int32, device=dev)
        rows_out = torch.full((X.shape[0],), -1, dtype=torch.int32, device=dev)
        predict_cuda.early_stop_block(p, X.to(dev), s, C, margin,
                                      None if rows_in is None else rows_in.to(dev),
                                      counts[0:1], rows_out, counts[1:2])
        n = int(counts[1])
        out.append((s.cpu(), torch.sort(rows_out[:n].cpu().long()).values, n))
    return out


def _same_bits(a, b):
    """Bit-equal, but where both are NaN: the card's adds return the
    canonical NaN where the CPU's keep the input NaN's payload."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def _check(cuda, packed, X, scores, C, margin, rows_in, count):
    before = predict_cuda.launches["predict_early_stop"]
    (s_d, l_d, n_d), (s_h, l_h, n_h) = _block(cuda, packed, X, scores, C, margin, rows_in,
                                             count)
    assert predict_cuda.launches["predict_early_stop"] == before + 1
    assert n_d == n_h
    assert _same_bits(s_d, s_h)
    assert torch.equal(l_d, l_h)
    again = _block(cuda, packed, X, scores, C, margin, rows_in, count)[0]
    assert torch.equal(again[0].view(torch.int32), s_d.view(torch.int32))
    return n_d


def _packs(model, cuda, start, end):
    return {"cuda": pack_ensemble(model.trees, device=cuda).tree_slice(start, end),
            "cpu": pack_ensemble(model.trees).tree_slice(start, end)}


@pytest.mark.parametrize("margin", [0.0, 4.0, float("inf"), -1.0])
@pytest.mark.parametrize("C", [1, 3])
def test_block_kernel_matches_plain(cuda, C, margin):
    F, n = 12, 6000
    model = _forest(C, 12, 31, F, 3 + C, cats=(4,))
    rng = np.random.RandomState(7 + C)
    X = torch.from_numpy(make_rows(rng, n, F, (4,)))
    X[torch.from_numpy(rng.rand(n, F) < 0.02)] = float("inf")
    X[torch.from_numpy(rng.rand(n, F) < 0.02)] = float("-inf")
    scores = torch.from_numpy(rng.normal(size=(n, C)).astype(np.float32))
    rows = torch.from_numpy(rng.permutation(n).astype(np.int32))
    m = torch.tensor(margin, dtype=torch.float32).item()
    # the first block (no list, every row), a listed block, a short last one
    for start, end, rows_in, count in ((0, 4 * C, None, n), (4 * C, 8 * C, rows, n - 777),
                                       (11 * C, 12 * C, rows, 3001), (0, 4 * C, rows, 0)):
        kept = _check(cuda, _packs(model, cuda, start, end), X, scores, C, m, rows_in, count)
        if margin < 0:
            assert kept == 0
        if margin == float("inf"):
            assert kept == count


@pytest.mark.parametrize("C", [1, 3])
def test_block_kernel_on_special_scores(cuda, C):
    """Running scores with NaN, +-inf, signed zeros and ties in the top two."""
    F, n = 8, 4000
    model = _forest(C, 4, 15, F, 11 + C)
    rng = np.random.RandomState(13 + C)
    X = torch.from_numpy(make_rows(rng, n, F))
    init = rng.normal(size=(n, C)).astype(np.float32)
    pick = rng.rand(n, C) < 0.3
    init[pick] = rng.choice(np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5], np.float32),
                            size=int(pick.sum()))
    if C > 1:
        init[:200, 1] = init[:200, 0]
        init[200:250] = np.inf
        init[250:300, :2] = np.nan
    for margin in (0.25, 3.0):
        _check(cuda, _packs(model, cuda, 0, 2 * C), X, torch.from_numpy(init), C, margin,
               None, n)


@pytest.mark.parametrize("layout", ["odd_width", "unaligned_view", "wide", "large_block",
                                    "linear"])
def test_block_kernel_layouts(cuda, layout):
    """Words in place of vectors (F odd, X off 16 bytes), X read from
    global memory (too wide to stage), the trees read from global memory (a
    block past the shared budget), and linear leaves."""
    n = 5000
    F = {"odd_width": 7, "wide": 140}.get(layout, 12)
    iters, leaves = (40, 255) if layout == "large_block" else (6, 31)
    rng = np.random.RandomState(17)
    if layout == "linear":
        import lightgbm_tpu_torch as lt

        Xt = rng.normal(size=(3000, F))
        y = Xt[:, 0] * 2 + Xt[:, 1] + rng.normal(size=3000) * 0.1
        model = lt.train({"objective": "regression", "linear_tree": True, "num_leaves": 7,
                          "device_type": "cpu", "verbosity": -1},
                         lt.Dataset(Xt, label=y), num_boost_round=6)._gbdt
        trees = model.models
    else:
        trees = _forest(1, iters, leaves, F, 19).trees
    packs = {"cuda": pack_ensemble(trees, device=cuda), "cpu": pack_ensemble(trees)}
    packs = {k: p.tree_slice(0, len(trees)) for k, p in packs.items()}
    plan = predict_cuda.early_stop_plan(len(trees), F, packs["cpu"].records.shape[1], True)
    assert plan.stage_trees == (layout != "large_block")
    assert plan.stage_x == (layout != "wide")
    X = torch.from_numpy(make_rows(rng, n + 1, F)[:, :F].copy())
    if layout == "linear":
        X[torch.from_numpy(rng.rand(n + 1, F) < 0.02)] = float("nan")
    if layout == "unaligned_view":
        flat = torch.from_numpy(make_rows(rng, n * F + 1, 1).reshape(-1)).to(cuda)
        X_d = flat[1:].view(n, F)  # 4 bytes past the allocation's start
        assert X_d.data_ptr() % 16 != 0
        res = []
        for dev, Xv in ((cuda, X_d), (torch.device("cpu"), X_d.cpu())):
            s = torch.zeros((n, 1), device=dev)
            counts = torch.tensor([n, 0], dtype=torch.int32, device=dev)
            out = torch.full((n,), -1, dtype=torch.int32, device=dev)
            predict_cuda.early_stop_block(packs[dev.type], Xv, s, 1, 0.5, None, counts[0:1],
                                          out, counts[1:2])
            res.append((s.cpu(), torch.sort(out[:int(counts[1])].cpu().long()).values))
        assert torch.equal(res[0][0].view(torch.int32), res[1][0].view(torch.int32))
        assert torch.equal(res[0][1], res[1][1])
        return
    X = X[:n].contiguous()
    rows = torch.from_numpy(rng.permutation(n).astype(np.int32))  # n // 2 listed
    scores = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    _check(cuda, packs, X, scores, 1, 0.5, rows, n // 2)
    _check(cuda, packs, X, scores, 1, 0.5, None, n)


def test_block_kernel_at_the_main_path_shape(cuda):
    """Phase 6's block: 10 trees of 255 leaves over 262,144 rows x 28."""
    F, n = 28, 262_144
    model = _forest(1, 10, 255, F, 23)
    rng = np.random.RandomState(29)
    X = torch.from_numpy(make_rows(rng, n, F))
    scores = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    packs = _packs(model, cuda, 0, 10)
    kept = _check(cuda, packs, X, scores, 1, 4.0, None, n)
    assert 0 < kept < n
    rows = torch.from_numpy(rng.permutation(n).astype(np.int32))
    _check(cuda, packs, X, scores, 1, 4.0, rows, n - 12345)


@pytest.mark.parametrize("C", [1, 3])
def test_early_stopped_predict_on_card_launches_one_kernel_a_block(cuda, C):
    F, n = 10, 20000
    model = _forest(C, 20, 31, F, 31 + C, cats=(4,))
    X = torch.from_numpy(make_rows(np.random.RandomState(37), n, F, (4,)))
    packed, packed_d = pack_ensemble(model.trees), pack_ensemble(model.trees, device=cuda)
    for margin, period in ((0.8, 5), (0.0, 3), (float("inf"), 7)):
        before = predict_cuda.launches["predict_early_stop"]
        got = predict_raw_early_stop(packed_d, X.to(cuda), C, period, margin)
        assert predict_cuda.launches["predict_early_stop"] == before + -(-20 // period)
        want = predict_raw_early_stop(packed, X, C, period, margin)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
