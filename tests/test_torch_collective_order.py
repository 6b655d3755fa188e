"""The sanitizer's collective-order check (lightgbm_tpu_torch/utils/
sanitize.py, parallel/dist.py), the port of the JAX package's
tests/test_sanitize.py:149-255.

Contracts:
* while the sanitizer is on, each collective of parallel/dist.py over a
  gang (all_reduce, reduce_scatter, all_gather, all_gather_rows) is
  recorded once as (op, group size), with a rolling CRC; off, nothing is
  recorded and the check is a no-op;
* the check names the first divergent op (a fake gather whose peer's
  second op differs), and a count mismatch (a peer that issued one more),
  as the JAX package's check does on the same fake peers;
* the fingerprint vector is the JAX package's [count, prefix CRCs] for the
  same notes, with the whole window's CRC after it;
* a passing check closes the window (the list stays bounded and the op
  numbers go on counting), and a divergence after the window's 32nd op,
  at the same count, still raises;
* across a gloo gang of 2 ranks, where rank 0 all-reduces and rank 1
  reduce-scatters (one gloo all-reduce either way), both ranks raise
  CollectiveOrderError naming their own op, and the agreeing sequence
  before it passes.
"""
import numpy as np
import pytest

from lightgbm_tpu_torch.utils import sanitize
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.torch_gang import run_gang


@pytest.fixture(autouse=True)
def _sanitizer_off():
    yield
    sanitize.disable()
    sanitize.clear_override()
    sanitize.reset()


def _issue(*ops):
    for op in ops:
        sanitize.note_collective(op, 2)


def test_collective_probe_records_the_sequence():
    sanitize.enable("cpu")
    sanitize.reset()
    _issue("all_reduce")
    assert sanitize.collective_sequence() == [("all_reduce", "2")]
    count, crc = sanitize.collective_fingerprint()
    assert count == 1 and crc != 0
    _issue("all_reduce")
    # a host call is recorded every time it is issued (the JAX package
    # records a traced collective once a program)
    assert sanitize.collective_fingerprint()[0] == 2


def test_collective_probe_inert_when_disabled():
    from lightgbm_tpu_torch.parallel import dist

    sanitize.enable("cpu")
    sanitize.disable()
    sanitize.reset()
    world = type("W", (), {"size": 2})()
    dist._record("all_reduce", world)
    assert sanitize.collective_sequence() == []
    sanitize.check_collective_order(gather_fn=lambda vec: 1 / 0)  # a no-op


def _divergent(vec):
    other = np.array(vec, copy=True)
    other[2] ^= 0x5A5A  # the fake peer's second op differs
    return np.stack([vec, other])


def _longer_peer(vec):
    other = np.array(vec, copy=True)
    other[0] += 1  # the peer issued one more collective...
    other[2] = 12345  # ...so its second prefix slot is set
    return np.stack([vec, other])


def test_collective_order_check_names_first_divergent_op():
    sanitize.enable("cpu")
    sanitize.reset()
    _issue("all_reduce", "all_gather")
    sanitize.check_collective_order(gather_fn=lambda vec: np.stack([vec, vec]))
    assert sanitize.collective_sequence() == []  # the agreeing window closed
    _issue("all_reduce", "all_gather")
    with pytest.raises(sanitize.CollectiveOrderError) as exc:
        sanitize.check_collective_order(gather_fn=_divergent)
    assert exc.value.first_divergent_op == "all_gather@2"
    assert exc.value.rank == 0
    assert "op #3" in str(exc.value)  # numbered from the run's first op


def test_collective_order_check_flags_count_mismatch():
    sanitize.enable("cpu")
    sanitize.reset()
    _issue("all_reduce")
    with pytest.raises(sanitize.CollectiveOrderError) as exc:
        sanitize.check_collective_order(gather_fn=_longer_peer)
    assert exc.value.first_divergent_op.startswith("<none:")
    assert "issued 1 collective(s)" in exc.value.first_divergent_op


def test_collective_order_check_sees_a_divergence_after_op_32():
    sanitize.enable("cpu")
    sanitize.reset()
    ops = ["all_reduce", "all_gather", "reduce_scatter"] * 14  # 42 ops
    _issue(*ops)
    sanitize.check_collective_order(gather_fn=lambda vec: np.stack([vec, vec]))
    assert sanitize.collective_sequence() == []
    assert sanitize.collective_fingerprint() == (42, 0)
    _issue(*ops)
    vec = sanitize._fingerprint_vector()
    assert vec[0] == 84 and vec[sanitize._FP_SLOTS] != 0
    other = np.array(vec, copy=True)
    other[-1] ^= 0x5A5A  # same count, same 32 prefixes: the peer's 40th op differs

    with pytest.raises(sanitize.CollectiveOrderError) as exc:
        sanitize.check_collective_order(gather_fn=lambda v: np.stack([v, other]))
    assert exc.value.first_divergent_op.startswith("<after op #73:")
    assert "op #74" in str(exc.value)
    assert len(sanitize.collective_sequence()) == 42  # a failed check keeps its window


@pytest.mark.parametrize("n", [1, 5, 32, 40])
def test_fingerprint_vector_equals_jax(jax_ref, n):
    from lightgbm_tpu.utils import sanitize as jax_sanitize

    names = [("all_reduce", "all_gather", "reduce_scatter", "psum")[i % 4] for i in range(n)]
    sanitize.enable("cpu")
    sanitize.reset()
    jax_sanitize.reset()
    try:
        for i, op in enumerate(names):
            sanitize.note_collective(op, 2 + i % 3)
            jax_sanitize._note_collective(op, 2 + i % 3)
        theirs = jax_sanitize._fingerprint_vector()
        assert sanitize.collective_sequence() == jax_sanitize.collective_sequence()
        assert sanitize.collective_fingerprint() == jax_sanitize.collective_fingerprint()
    finally:
        jax_sanitize.reset()
    mine = sanitize._fingerprint_vector()
    assert theirs.dtype == np.uint32 and mine.dtype == np.int64
    np.testing.assert_array_equal(mine[:-1], theirs.astype(np.int64))
    assert mine[-1] == sanitize.collective_fingerprint()[1]


@pytest.mark.parametrize("peer", [_divergent, _longer_peer], ids=["second-op", "count"])
def test_check_names_the_op_the_jax_check_names(jax_ref, monkeypatch, peer):
    from lightgbm_tpu.utils import sanitize as jax_sanitize

    sanitize.enable("cpu")
    sanitize.reset()
    # on without enable(), which would patch jax.Array and jax.lax for good
    monkeypatch.setattr(jax_sanitize, "_forced", True)
    jax_sanitize.reset()
    try:
        for op in ("all_reduce", "all_gather", "all_reduce"):
            sanitize.note_collective(op, 2)
            jax_sanitize._note_collective(op, 2)
        with pytest.raises(jax_sanitize.CollectiveOrderError) as theirs:
            jax_sanitize.check_collective_order(gather_fn=peer)
    finally:
        jax_sanitize.reset()
    with pytest.raises(sanitize.CollectiveOrderError) as mine:
        sanitize.check_collective_order(gather_fn=peer)
    assert mine.value.rank == theirs.value.rank == 0
    if peer is _divergent:
        assert mine.value.first_divergent_op == theirs.value.first_divergent_op
    else:  # "issued" where the JAX package says "traced"
        assert mine.value.first_divergent_op == \
            theirs.value.first_divergent_op.replace("traced", "issued")


def test_collective_order_divergence_across_gloo_gang(tmp_path):
    out = run_gang("collective_order", 2, tmp_path, timeout=60)
    want = [("all_reduce", "2"), ("reduce_scatter", "2"), ("all_gather", "2"),
            ("all_gather_rows", "2")]
    for rank, res in enumerate(out):
        assert res["seq"] == want
        # the agreeing window closed, and the check's own gather is not recorded
        assert res["window"] == [("all_reduce" if rank == 0 else "reduce_scatter", "2")]
        raiser, op, msg = res["caught"]
        assert raiser == rank
        assert op == ("all_reduce@2" if rank == 0 else "reduce_scatter@2")
        assert "op #4" in msg
