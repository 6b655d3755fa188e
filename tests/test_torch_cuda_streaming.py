"""The leaf histogram's carried mode and the streamed learner on the card.

Marked `gpu`: these need an NVIDIA card with nvcc, and skip elsewhere. Run
them on the card with `python -m pytest -m gpu --noconftest
tests/test_torch_cuda_streaming.py`. Whether a card is present is decided
inside the fixture, never at import.

Contracts: the carried mode over a leaf's blocks (block-local indices, gh
offset to each block, the tree's exponents) is bit-equal to one resident
call over all the leaf's rows and to the plain fixed-point emulation, in
the float and the integer modes; the streamed learner under a starved
budget trains the resident serial learner's model text on the card, its
cache never holding more than its capacity; a graph capture runs on a
stream of the capturing thread's own, never on a stream another thread
copies on; the wave learner captures its graphs while a prediction service
answers from other threads, and neither fails.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.histogram import (_build_histogram_rows_fixed,
                                              fixed_point_exponents)
from lightgbm_tpu_torch.streaming import StreamedTreeLearner
from lightgbm_tpu_torch.streaming.learner import BLOCK_ROWS_ENV, BUDGET_ENV, block_runs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _carried(bins, gh, idx, num_bins, block, exps):
    carry = hist_cuda.HistogramCarry()
    runs = block_runs(idx, block)
    out = None
    for i, (b, s, e) in enumerate(runs):
        lo, hi = b * block, min(bins.shape[1], (b + 1) * block)
        out = hist_cuda.histogram(bins[:, lo:hi].contiguous(), gh[lo:hi],
                                  (idx[s:e] - lo).to(torch.int32), num_bins, count=e - s,
                                  exponents=exps, carry=carry, last=i + 1 == len(runs))
    return out, len(runs)


@pytest.mark.parametrize("quantized", [False, True])
def test_carried_mode_bit_equal_to_one_call_and_plain(cuda, quantized):
    rng = np.random.RandomState(7)
    G, N, B, block = 28, 200_000, 255, 16_384
    bins = torch.from_numpy(rng.randint(0, B, size=(G, N)).astype(np.uint8)).to(cuda)
    if quantized:
        gh = torch.from_numpy(rng.randint(-8, 9, size=(N + 1, 3)).astype(np.int8))
    else:
        gh = torch.from_numpy(rng.standard_normal((N + 1, 3)).astype(np.float32))
    gh[N] = 0
    gh = gh.to(cuda)
    exps = None if quantized else fixed_point_exponents(gh, N)
    for rows in (np.arange(N), np.sort(rng.choice(N, 50_000, replace=False)),
                 np.sort(rng.choice(N, 4_000, replace=False))):
        idx = torch.from_numpy(rows.astype(np.int32)).to(cuda)
        before = hist_cuda.launches["histogram_carry_i32" if quantized else "histogram_carry"]
        got, n_runs = _carried(bins, gh, idx, B, block, exps)
        resident = hist_cuda.histogram(bins, gh, idx, B, count=idx.shape[0], exponents=exps)
        torch.cuda.synchronize()
        assert hist_cuda.launches["histogram_carry_i32" if quantized else "histogram_carry"] \
            == before + n_runs
        assert torch.equal(got, resident)
        plain = _build_histogram_rows_fixed(bins.cpu(), gh.cpu(), idx.cpu(), B,
                                            None if exps is None else exps.cpu())
        assert torch.equal(got.cpu(), plain)


def test_streamed_learner_byte_equal_to_resident_on_the_card(cuda, monkeypatch):
    rng = np.random.RandomState(3)
    X = rng.standard_normal((20_000, 12)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + rng.standard_normal(20_000) * 0.3 > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 31, "feature_fraction_bynode": 0.8,
              "verbosity": -1}
    resident = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=4)
    monkeypatch.setenv(BLOCK_ROWS_ENV, "2048")
    monkeypatch.setenv(BUDGET_ENV, str(2 * 12 * 2048))
    streamed = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=4)
    learner = streamed._gbdt.tree_learner
    assert isinstance(learner, StreamedTreeLearner) and learner.bins_dev is None
    assert learner._cache.peak <= learner._cache.capacity == 2
    assert streamed.model_to_string() == resident.model_to_string()


def test_wave_training_while_serving_in_the_same_process(cuda):
    """The flywheel's shape: a PredictionService answers from its threads
    while the wave learner captures and launches its tree graphs. The
    captures are thread-local, so neither side fails."""
    import threading

    from lightgbm_tpu_torch.serving import PredictionService
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner

    rng = np.random.RandomState(5)
    X = rng.standard_normal((30_000, 12)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    first = lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=2)
    svc = PredictionService(max_batch_rows=512, batch_window_s=0.0005)
    failures, answers, done = [], [], threading.Event()
    try:
        svc.load_model("m", booster=first)

        def hammer():
            while not done.is_set():
                try:
                    answers.append(svc.predict("m", X[:64], raw_score=True))
                except Exception as e:  # noqa: BLE001 - what the test counts
                    failures.append(repr(e))

        threads = [threading.Thread(target=hammer) for _ in range(2)]
        for t in threads:
            t.start()
        bst = lt.train(dict(params), lt.Dataset(X[1000:], label=y[1000:]), num_boost_round=6)
        done.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        done.set()
        svc.close()
    assert isinstance(bst._gbdt.tree_learner, DeviceTreeLearner)
    assert failures == [] and answers
    want = first.predict(X[:64], raw_score=True)
    assert all(np.array_equal(a, want) for a in answers)


def test_captures_take_no_stream_another_thread_works_on(cuda):
    """A graph capture runs on the capturing thread's own stream
    (ops/cuda_build.py:capture_stream), never on one of the pool streams
    that torch.cuda.Stream() hands out round robin: while 64 captures run,
    a thread copying pageable host rows to the card and back on a pool
    stream (as a serving batcher does) never fails, and no graph takes in
    its work."""
    import threading

    from lightgbm_tpu_torch.ops.cuda_build import CountedGraph, capture_stream

    own = capture_stream()
    assert capture_stream() is own
    assert own.cuda_stream not in {torch.cuda.Stream().cuda_stream for _ in range(64)}
    host = np.arange(4096, dtype=np.float32)
    failures, copies, done = [], [0], threading.Event()

    def copier():
        with torch.cuda.stream(torch.cuda.Stream()):
            while not done.is_set():
                try:
                    back = torch.from_numpy(host).to(cuda).mul_(2).cpu().numpy()
                    if not np.array_equal(back, host * 2):
                        failures.append("a copy came back wrong")
                    copies[0] += 1
                except Exception as e:  # noqa: BLE001 - what the test counts
                    failures.append(repr(e))

    thread = threading.Thread(target=copier)
    x = torch.zeros(1024, device=cuda)
    x.add_(0)
    thread.start()
    try:
        graphs = [CountedGraph(lambda: x.add_(1)) for _ in range(64)]
        for g in graphs:
            g.replay()
        torch.cuda.synchronize()
    finally:
        done.set()
        thread.join(timeout=120)
    assert not thread.is_alive()
    assert failures == [] and copies[0] > 0
    assert torch.equal(x, torch.full_like(x, 64.0))
