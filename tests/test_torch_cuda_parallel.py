"""The ragged histogram's image mode, the conversion kernel and the
distributed learners on the card.

Marked `gpu`: these need an NVIDIA card with nvcc, and skip elsewhere. Run
them on the card with `python -m pytest -m gpu --noconftest
tests/test_torch_cuda_parallel.py`. Whether a card is present is decided
inside the fixture, never at import.

Contracts: the image mode (the int64 fixed-point sums and flag words, left
unconverted) is bit-equal to its plain version, at the root and on ranges,
with +inf, -inf and NaN gradients among the rows; the conversion kernel is
bit-equal to its plain version and to the float mode's own result; the
leaf histogram's image mode likewise. A gang of 2 ranks on the card (gloo,
staged through pinned host memory; NCCL needs a card a rank) grows, on raw
(unsnapped) gradients, the single-card wave learner's trees through the
data-, voting- (top_k >= F) and feature-parallel wave learners, bagged too,
and the serial learner's through the host-driven data-parallel learner.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.histogram import (_histogram_slots_ragged_image_plain,
                                              _image_to_float_plain, fixed_point_exponents)
from torch_gang import N_ROWS, grow_trees, run_gang

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _inputs(rng, G, N, B, nonfinite):
    bins = torch.from_numpy(rng.randint(0, B, size=(G, N)).astype(np.uint8))
    gh = torch.from_numpy(rng.standard_normal((N, 3)).astype(np.float32))
    if nonfinite:
        gh[3, 0], gh[4, 1], gh[5, 2], gh[6, 0] = float("inf"), float("-inf"), float("nan"), \
            float("-inf")
    return bins, gh


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("K", [1, 21])
def test_image_mode_and_conversion_bit_equal_to_plain(cuda, K, nonfinite):
    rng = np.random.RandomState(K)
    G, N, B = 28, 200_000, 255
    bins, gh = _inputs(rng, G, N, B, False)
    cuts = np.sort(rng.choice(N, 2 * K, replace=False)).astype(np.int32)
    starts, ends = torch.from_numpy(cuts[0::2].copy()), torch.from_numpy(cuts[1::2].copy())
    if nonfinite:  # inside the first range
        s = int(starts[0])
        gh[s, 0], gh[s + 1, 1], gh[s + 2, 2], gh[s + 3, 0] = (float("inf"), float("-inf"),
                                                              float("nan"), float("-inf"))
    slot = torch.full((N,), K, dtype=torch.int32)
    for k in range(K):
        slot[starts[k]:ends[k]] = k
    valid = torch.ones(K, dtype=torch.bool)
    exps = fixed_point_exponents(gh, N)
    args = (slot, starts, ends, valid)
    got = hist_cuda.histogram_ragged(bins.to(cuda), gh.to(cuda), *(a.to(cuda) for a in args),
                                     B, K, exponents=exps.to(cuda), image=True)
    ref = _histogram_slots_ragged_image_plain(bins, gh, *args, B, K, exps)
    assert torch.equal(got.sums.cpu(), ref.sums) and torch.equal(got.flags.cpu(), ref.flags)
    assert bool((ref.flags != 0).any()) == nonfinite
    conv = hist_cuda.image_to_float(got.sums, got.flags, exps.to(cuda))
    want = _image_to_float_plain(ref.sums, ref.flags, exps)
    assert torch.equal(conv.cpu().view(torch.int32), want.view(torch.int32))
    floated = hist_cuda.histogram_ragged(bins.to(cuda), gh.to(cuda),
                                         *(a.to(cuda) for a in args), B, K,
                                         exponents=exps.to(cuda))
    assert torch.equal(conv.view(torch.int32), floated.view(torch.int32))


def test_leaf_histogram_image_mode_bit_equal_to_plain(cuda):
    rng = np.random.RandomState(3)
    G, N, B = 12, 100_000, 64
    bins, gh = _inputs(rng, G, N, B, True)
    idx = torch.from_numpy(np.sort(rng.choice(N, 30_000, replace=False)).astype(np.int32))
    exps = fixed_point_exponents(gh, N)
    got = hist_cuda.histogram(bins.to(cuda), gh.to(cuda), idx.to(cuda), B, count=30_000,
                              exponents=exps.to(cuda), image=True)
    ref = hist_cuda.histogram(bins, gh, idx, B, count=30_000, exponents=exps, image=True)
    assert torch.equal(got.sums.cpu(), ref.sums) and torch.equal(got.flags.cpu(), ref.flags)


BASE = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5}
CASES = [("DeviceDataParallelTreeLearner", BASE, False),
         ("DeviceDataParallelTreeLearner", BASE, True),
         ("VotingDataParallelTreeLearner", dict(BASE, top_k=20), False),
         ("DeviceFeatureParallelTreeLearner", BASE, True),
         ("DataParallelTreeLearner", dict(BASE, feature_fraction_bynode=0.8), False)]


@pytest.fixture(scope="module")
def card_gang(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    bag = np.sort(np.random.RandomState(3).choice(N_ROWS, 900, replace=False))
    jobs = [(cls, params, {"device": "cuda", "snapped": False,
                           "bag": bag.astype(np.int32) if bagged else None})
            for cls, params, bagged in CASES]
    return bag, run_gang("grow_many", 2, tmp_path_factory.mktemp("card"), jobs, threads=2)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["data", "data-bagged", "voting", "feature-bagged", "host-data"])
def test_gang_on_the_card_grows_the_single_card_trees(cuda, card_gang, i):
    bag, out = card_gang
    cls, params, bagged = CASES[i]
    single = "SerialTreeLearner" if cls == "DataParallelTreeLearner" else "DeviceTreeLearner"
    want = grow_trees(single, params, device="cuda", snapped=False,
                      bag=bag.astype(np.int32) if bagged else None)
    for r in out:
        for got, ref in zip(r[i], want):
            assert got["tree"] == ref["tree"]
            if ref["ids"] is not None and got["ids"] is not None:
                np.testing.assert_array_equal(got["ids"], ref["ids"])
