"""The port's row compaction (ops/compact.py; its plain version is what the
CUDA kernel is held against on the card) against the JAX package's
``ops/compact_pallas.py``: the forward map and left counts of
`range_partition_dst`, and `compact_rows` through the XLA permutation
scatter and through the Pallas kernel in interpret mode.

Contract: bit-equal, on the shapes of ``tests/test_compact_pallas.py``
(2,048 rows, ranges that are spread out, adjacent and tiny, tile-aligned,
and the whole row set). Positions and payloads are moved, never summed.
The one exception is the JAX Pallas kernel's own: it returns a -0.0
payload as +0.0, so against it the payload is held equal in value.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import compact_cuda
from lightgbm_tpu_torch.ops.compact import (compact_rows, exclusive_cumsum,
                                            range_partition_dst,
                                            range_partition_dst_by_range)
from test_torch_wave_cases import WAVE_CASES, WAVE_N, partition_inputs, wave_case
from tests.test_torch_ref import jax_ref  # noqa: F401

N = 2048
CASES = [
    ("multi", [(64, 300), (512, 512), (1100, 180), (1280, 250)]),
    ("adjacent_tiny", [(0, 7), (7, 9), (16, 3), (19, 501)]),
    ("tile_aligned", [(0, 512), (1024, 512)]),
    ("full", [(0, 2048)]),
]


def _inputs(seed, ranges, valid=None):
    rng = np.random.RandomState(seed)
    go_left = rng.rand(N) < 0.45
    K = len(ranges)
    valid = np.ones(K, bool) if valid is None else np.asarray(valid)
    match = np.zeros((N, K), dtype=bool)
    for k, (s, c) in enumerate(ranges):
        match[s:s + c, k] = valid[k]
    starts = np.asarray([s for s, _ in ranges], np.int32)
    counts = np.asarray([c for _, c in ranges], np.int32)
    return go_left, match, starts, counts, valid


def _oracle_dst(go_left, ranges, valid):
    """Within each valid range, rows ordered by (right side, position)."""
    dst = np.arange(N)
    for (s, c), ok in zip(ranges, valid):
        if ok:
            order = np.argsort(~go_left[s:s + c], kind="stable") + s
            dst[order] = np.arange(s, s + c)
    return dst


@pytest.mark.parametrize("name,ranges", CASES, ids=[c[0] for c in CASES])
def test_range_partition_dst_matches_jax(jax_ref, name, ranges):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.compact_pallas import range_partition_dst as jax_dst

    valid = [k % 3 != 1 for k in range(len(ranges))] if len(ranges) > 2 else None
    go_left, match, starts, counts, valid = _inputs(len(ranges), ranges, valid)
    dst, n_left = range_partition_dst(
        torch.from_numpy(go_left), torch.from_numpy(match), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(valid))
    ref_dst, ref_left = jax_dst(jnp.asarray(go_left), jnp.asarray(match),
                                jnp.asarray(starts), jnp.asarray(counts),
                                jnp.asarray(valid))
    assert dst.dtype == torch.int32 and n_left.dtype == torch.int32
    np.testing.assert_array_equal(dst.numpy(), np.asarray(ref_dst))
    np.testing.assert_array_equal(n_left.numpy(), np.asarray(ref_left))
    np.testing.assert_array_equal(dst.numpy(), _oracle_dst(go_left, ranges, valid))


def test_range_index_form_matches_membership_form():
    ranges = CASES[0][1]
    go_left, match, starts, counts, valid = _inputs(7, ranges)
    K = len(ranges)
    rng = np.where(match.any(1), match.argmax(1), K).astype(np.int32)
    a = range_partition_dst(torch.from_numpy(go_left), torch.from_numpy(match),
                            torch.from_numpy(starts), torch.from_numpy(counts),
                            torch.from_numpy(valid))
    b = range_partition_dst_by_range(torch.from_numpy(go_left), torch.from_numpy(rng),
                                     torch.from_numpy(starts), torch.from_numpy(counts),
                                     torch.from_numpy(valid))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    x = torch.tensor([True, False, True, True])
    assert exclusive_cumsum(x).tolist() == [0, 1, 1, 2]


@pytest.mark.parametrize("name,ranges", CASES, ids=[c[0] for c in CASES])
def test_compact_rows_matches_jax(jax_ref, name, ranges):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.compact_pallas import compact_rows as jax_compact

    go_left, match, starts, counts, valid = _inputs(11 + len(ranges), ranges)
    rng = np.random.RandomState(len(name))
    G, rc = 8, 5
    bins = rng.randint(0, 256, size=(G, N)).astype(np.uint8)
    row = rng.randn(N, rc).astype(np.float32)
    row[:, 3] = np.arange(N)  # a position column rides along
    row[5, 1] = np.float32("nan")
    row[6, 0] = -0.0
    dst, _ = range_partition_dst(
        torch.from_numpy(go_left), torch.from_numpy(match), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(valid))
    before = dict(compact_cuda.launches)
    out_b, out_r = compact_rows(torch.from_numpy(bins), torch.from_numpy(row), dst)
    assert compact_cuda.launches == before  # a CPU tensor launches nothing
    assert out_b.dtype == torch.uint8 and out_r.dtype == torch.float32
    cm = ([match[:, k] & go_left for k in range(len(ranges))]
          + [match[:, k] & ~go_left for k in range(len(ranges))])
    d = jnp.asarray(dst.numpy())
    for use_pallas in (False, True):
        ref_b, ref_r = jax_compact(jnp.asarray(bins), jnp.asarray(row), d,
                                   [jnp.asarray(m) for m in cm],
                                   jnp.asarray(match.any(1)), tile=256,
                                   use_pallas=use_pallas, interpret=True)
        np.testing.assert_array_equal(out_b.numpy(), np.asarray(ref_b))
        if use_pallas:
            # the Pallas kernel accumulates each output tile onto +0.0, which
            # turns a -0.0 payload into +0.0 (ROADMAP Queue 3); every other
            # value, NaN included, comes through
            np.testing.assert_array_equal(out_r.numpy(), np.asarray(ref_r))
        else:
            np.testing.assert_array_equal(out_r.numpy().view(np.uint32),
                                          np.asarray(ref_r).view(np.uint32))
    # into a caller's buffers, as the wave learner compacts
    bufs = (torch.full_like(out_b, 7), torch.full_like(out_r, 3.0))
    got = compact_rows(torch.from_numpy(bins), torch.from_numpy(row), dst, out=bufs)
    assert got[0] is bufs[0] and got[1] is bufs[1]
    assert torch.equal(bufs[0], out_b)
    assert torch.equal(bufs[1].view(torch.int32), out_r.view(torch.int32))


# --- the wave partition: decide, partition and move from the wave's tables


def _jax_wave_partition(case, row):
    """The JAX wave's partition of a case (treelearner/device.py:503-514 for
    the bagged form, 603-666 otherwise), with the learner's own functions
    and its per-row formulas: (bins, rows, n_left, slot)."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.compact_pallas import compact_rows as jax_compact
    from lightgbm_tpu.ops.compact_pallas import range_partition_dst as jax_dst
    from lightgbm_tpu.treelearner.device import _decide_go_left

    N = row.shape[0]
    bins = jnp.asarray(case["bins"])
    if "fields" not in case:
        in_bag = jnp.asarray(row[:, 4] == 0)
        dst, nl = jax_dst(in_bag, jnp.ones((N, 1), bool), jnp.zeros(1, jnp.int32),
                          jnp.full(1, N, jnp.int32), jnp.ones(1, bool))
        b, r = jax_compact(bins, jnp.asarray(row), dst, [in_bag, ~in_bag],
                           jnp.ones(N, bool), use_pallas=False)
        return np.asarray(b), np.asarray(r), np.asarray(nl), None
    K = case["K"]
    f = case["fields"]
    pos = jnp.arange(N, dtype=jnp.int32)
    s_k, c_k = jnp.asarray(case["starts"]), jnp.asarray(case["counts"])
    sel_ok = jnp.asarray(case["sel_ok"])
    match = (pos[:, None] >= s_k[None, :]) & (pos[:, None] < (s_k + c_k)[None, :]) \
        & sel_ok[None, :]
    kvalid = match.any(axis=1)
    r = jnp.argmax(match, axis=1)
    col = {k: jnp.asarray(v)[r] for k, v in f.items()}
    gb = jnp.asarray(case["bins"])[col["group"], pos]
    go_left = _decide_go_left(gb, col["thresh"], col["default_left"], col["missing_type"],
                              col["default_bin"], col["nbins"], col["lo"], col["hi"],
                              col["is_efb"])
    dst, nl = jax_dst(go_left, match, s_k, c_k, sel_ok)
    cmasks = ([match[:, k] & go_left for k in range(K)]
              + [match[:, k] & ~go_left for k in range(K)])
    b, rr = jax_compact(bins, jnp.asarray(row), dst, cmasks, kvalid, use_pallas=False)
    nr = c_k - nl
    left_small = nl <= nr
    ss = jnp.where(left_small, s_k, s_k + nl)
    se = ss + jnp.minimum(nl, nr)
    in_s = (pos[:, None] >= ss[None, :]) & (pos[:, None] < se[None, :]) & sel_ok[None, :]
    slot = jnp.where(in_s.any(axis=1), jnp.argmax(in_s, axis=1).astype(jnp.int32), K)
    return np.asarray(b), np.asarray(rr), np.asarray(nl), np.asarray(slot)


def _jax_relabel(row, table):
    """The JAX wave's relabel (treelearner/device.py:818-826): a row at or
    past a committed range's midpoint takes the new leaf id."""
    import jax.numpy as jnp

    mid, end, new = (jnp.asarray(a) for a in table)
    pos = jnp.arange(row.shape[0])
    hit = (pos[:, None] >= mid[None, :]) & (pos[:, None] < end[None, :])
    leafcol = jnp.where(hit.any(axis=1), new[jnp.argmax(hit, axis=1)].astype(jnp.float32),
                        jnp.asarray(row[:, 4]))
    return np.asarray(jnp.asarray(row).at[:, 4].set(leafcol))


@pytest.mark.parametrize("case_args", WAVE_CASES, ids=[c[0] for c in WAVE_CASES])
def test_partition_wave_matches_jax(jax_ref, case_args):
    from lightgbm_tpu_torch.ops.compact import partition_wave, relabel_rows

    name, n_leaves, K, n_invalid, order, form = case_args
    case = wave_case(len(name) * 7 + K, n_leaves, K, n_invalid, order, form)
    row = case["row"].copy()
    if "relabel" in case:
        ported = torch.from_numpy(row.copy())
        relabel_rows(ported, 4, torch.from_numpy(case["relabel"]))
        row = _jax_relabel(row, case["relabel"]).copy()
        np.testing.assert_array_equal(ported.numpy().view(np.uint32), row.view(np.uint32))
    slot = torch.full((WAVE_N,), -7, dtype=torch.int32)
    before = dict(compact_cuda.wave_launches)
    b, r, ranges, flags = partition_wave(
        torch.from_numpy(case["bins"]), torch.from_numpy(row), 4, *partition_inputs(case),
        bagged=form == "bagged", slot_out=slot)
    assert compact_cuda.wave_launches == before  # a CPU tensor launches nothing
    ref_b, ref_r, ref_nl, ref_slot = _jax_wave_partition(case, row)
    np.testing.assert_array_equal(b.numpy(), ref_b)
    np.testing.assert_array_equal(r.numpy().view(np.uint32), ref_r.view(np.uint32))
    np.testing.assert_array_equal(ranges[0].numpy(), ref_nl)
    if ref_slot is not None:
        np.testing.assert_array_equal(slot.numpy(), ref_slot)
    # the children: the smaller one's range, and which it is
    counts = case["counts"]
    nr = counts - ref_nl
    small = np.minimum(ref_nl, nr)
    left_small = ref_nl <= nr
    np.testing.assert_array_equal(ranges[1].numpy(),
                                  np.where(left_small, case["starts"], case["starts"] + ref_nl))
    np.testing.assert_array_equal(ranges[2].numpy() - ranges[1].numpy(), small)
    np.testing.assert_array_equal(flags[0].numpy(), (case["valid"] != 0) & (small > 0))
    np.testing.assert_array_equal(flags[1].numpy(), left_small)
    # the rows outside every valid range stay where they were
    moved = np.zeros(WAVE_N, bool)
    for s, c, ok in zip(case["starts"], counts, case["valid"]):
        moved[s:s + c] |= ok != 0
    np.testing.assert_array_equal(r.numpy()[~moved].view(np.uint32),
                                  row[~moved].view(np.uint32))
