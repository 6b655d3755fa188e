"""The port's cost model (perfmodel.py) on the CPU.

Contracts:

* every kernel's (bytes, operations) equals, exactly, the formula the smoke
  (chip_smoke.py) computed inline before the formulas moved here, on
  random shapes; and the bound equals the smoke's former bound (the H100's
  3.35e12 bytes/s and 67e12 float32 operations/s); the tree loop's one
  condition launch reads the done word, and the discretizer's passes add
  the float32 operations, integer operations and instructions issued that
  their SASS counts a row, the quantize pass bound by its instruction issue
  in the main path's stochastic mode;
* `bound_ms` names the largest of its four terms, the integer one the
  larger of the ALU-only opcodes and half of every integer one;
* `row_loop_mix` finds an innermost row loop in SASS text, counts its
  instructions a row by class (an unrolled loop's rows apart, ALU-only
  opcodes apart from those IMAD could run) and leaves out the block a
  predicated forward branch skips;
* the peak table has the card and no TPU entry;
* `attribution`'s stage fractions sum to 1 within 1e-9 with an explicit
  "other", and the byte model reads the wave learner's gauges;
* `parse_ptxas` reads ptxas -v's registers, shared memory and spills.
"""
import math

import numpy as np
import pytest

from lightgbm_tpu_torch import perfmodel as pm
from lightgbm_tpu_torch.ops.wave import REC, SCALARS, STORE

H100 = "NVIDIA H100 80GB HBM3"
_HBM, _F32 = 3.35e12, 67e12


def _old_bound(nbytes, ops):
    """chip_smoke.py's former `bound`."""
    t_bytes, t_ops = nbytes / _HBM * 1e3, ops / _F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _shapes(seed):
    rng = np.random.RandomState(seed)
    return {k: int(rng.randint(lo, hi)) for k, (lo, hi) in {
        "rows": (1, 2_000_000), "F": (1, 200), "T": (1, 1000), "G": (1, 200),
        "B": (2, 257), "K": (1, 64), "L": (2, 512), "n": (0, 64), "tiles": (1, 5000),
        "P": (1, 2_000_000), "tables": (0, 10_000_000), "rc": (1, 8),
        "out": (1, 1_000_000), "S": (1, 8)}.items()} | {
        "visits": float(rng.randint(0, 10**9)), "depth": float(rng.rand() * 12)}


def _old_formulas(s):
    """The smoke's inline formulas as they stood, keyed like the new ones."""
    rows, F, T, G, B, K, L, n = (s[k] for k in ("rows", "F", "T", "G", "B", "K", "L", "n"))
    tiles, P, tables, rc, out, S = (s[k] for k in ("tiles", "P", "tables", "rc", "out", "S"))
    visits, depth = s["visits"], s["depth"]
    per_leaf = F * B * 12 + 3 * 4 + 14 * 4
    find_tables = F * B * 9 + F * 4 * 4 + F + 6 * 4
    q_per_leaf = F * B * 12 + 3 * 4 + 14 * 4 + 3 * 4
    c_tables = F * B * 9 + F * 4 * 4 + 2 * F + 6 * 4
    return {
        "raw": (rows * F * 4 + rows * 4 + tables, visits + rows * T),
        "acc": (rows * F * 4 + 2 * rows * 4 + tables, visits + rows * T),
        "leaf": (rows * F * 4 + rows * T * 4 + tables, visits),
        "linear": (rows * F * 4 + rows * 4 + tables, rows * (depth + 2 * K + 1)),
        "ragged": (rows * (G + 12 + 4) + K * out, 3 * G * rows),
        "slots": (rows * (G + 12 + 4) + S * out, 3 * G * rows),
        "hist": (rows * (G + 12 + 4) + out, 3 * G * rows),
        "hist_i32": (rows * (G + 3 + 4) + out, 3 * G * rows),
        "compact": (2 * (G + 5 * 4) * rows + 4 * rows, 0),
        "decide": (rows * (4 * rc + 1) + rows / 8 + tiles * K * 4, 0),
        "scan": (2 * tiles * K * 4 + 3 * K * 4 + K * (3 * 4 + 2 + 4), 0),
        "scatter": (2 * rows * (G + 4 * rc) + 4 * rows + rows / 8 + tiles * K * 4, 0),
        "relabel": (4 * n, 0),
        "split_scan": (F * B * 3 * 4 + F * B + F * 14 + 6 * 4 + 3 * 4 + F * 14 * 4,
                       F * B * 2 * 30),
        "split_scan_batched": (L * (F * B * 3 * 4 + 3 * 4 + F * 14 * 4) + F * B + F * 14
                               + 6 * 4, L * F * B * 2 * 30),
        "find_one": (per_leaf + find_tables, F * B * 2 * 30),
        "find_batch": (2 * K * per_leaf + find_tables, 2 * K * F * B * 2 * 30),
        "find_int_one": (q_per_leaf + find_tables, F * B * 2 * 31),
        "find_int_batch": (2 * K * q_per_leaf + find_tables, 2 * K * F * B * 2 * 31),
        "find_constrained": (per_leaf + c_tables, F * B * 2 * 48),
        "select": (L * 4 + K * (3 * 4 + 2 * 4 + 6 * 4 + 1) + 8 + out * 4, 0),
        "replay": (L * 4 + K * 4 + 4 * K * 4 + K * 4 + 2 * K * 3 * 4 + 5 * 4 + SCALARS * 8
                   + n * (2 * (REC - 1) * 4 + 2 * 4 + REC * 4)
                   + n * (2 * REC * 4 + 2 * 4 + STORE * 4 + 3 * 4) + 5 * K * 8
                   + SCALARS * 8, 0),
    }


def _new_formulas(s):
    rows, F, T, G, B, K, L, n = (s[k] for k in ("rows", "F", "T", "G", "B", "K", "L", "n"))
    tiles, P, tables, rc, out, S = (s[k] for k in ("tiles", "P", "tables", "rc", "out", "S"))
    visits, depth = s["visits"], s["depth"]
    return {
        "raw": pm.traversal_raw(rows, F, T, tables, visits),
        "acc": pm.traversal_accumulate(rows, F, T, tables, visits),
        "leaf": pm.traversal_leaf(rows, F, T, tables, visits),
        "linear": pm.linear_score(rows, F, K, depth, tables),
        "ragged": pm.hist_ragged(rows, G, K, out),
        "slots": pm.hist_ragged(rows, G, S, out),
        "hist": pm.hist_rows(rows, G, out),
        "hist_i32": pm.hist_rows(rows, G, out, gh_bytes=3),
        "compact": pm.compact_rows(rows, G),
        "decide": pm.partition_decide(rows, rc, tiles, K),
        "scan": pm.partition_scan(tiles, K),
        "scatter": pm.partition_scatter(rows, G, rc, tiles, K),
        "relabel": pm.relabel(n),
        "split_scan": pm.split_scan(F, B),
        "split_scan_batched": pm.split_scan_batched(L, F, B),
        "find_one": pm.find_best_split(F, B),
        "find_batch": pm.find_best_split(F, B, 2 * K),
        "find_int_one": pm.find_best_split(F, B, quantized=True),
        "find_int_batch": pm.find_best_split(F, B, 2 * K, quantized=True),
        "find_constrained": pm.find_best_split(F, B, constrained=True),
        "select": pm.wave_select(L, K, out),
        "replay": pm.wave_replay(L, K, n),
    }


@pytest.mark.parametrize("seed", range(6))
def test_formulas_and_bounds_equal_the_smokes_former_ones(seed):
    s = _shapes(seed)
    old, new = _old_formulas(s), _new_formulas(s)
    assert old.keys() == new.keys()
    for key in old:
        assert tuple(new[key]) == tuple(old[key]), key
        assert pm.bound_ms(*new[key], H100) == _old_bound(*old[key]), key


def _bound(cost):
    return pm.bound_ms(*cost[:2], H100, *cost[2:])


@pytest.mark.parametrize("seed", range(3))
def test_tree_loop_and_quantize_formulas(seed):
    """Row 2c: the one condition launch a tree reads the done word. Row Q:
    the bytes as before, and the float32 operations, integer operations and
    instructions issued a row of the SASS's row loops; the integer term is
    the larger of the ALU-only opcodes and half of every integer one (the
    ALU and IMAD pipes, 132 x 64 x 1.98e9 a second each), the issue term
    every instruction at 132 x 128 x 1.98e9 a second."""
    rows = _shapes(seed)["rows"]
    assert pm.tree_loop_cond() == (8, 0.0)
    q_bytes = 8 * rows + 3 * (rows + 1) + 12 + 4 * 3 * 256
    # stochastic: 89 ALU-only of 109 on the ALU and 56 IMAD, 181 issued
    assert pm.quantize(rows) == (q_bytes, 11 * rows, 89 * rows, 181 * rows)
    # the reduce loop: 0.5 ALU-only of 3.5, 2.75 IMAD -> half of 6.25
    assert pm.quantize_reduce(rows) == (8 * rows + 4 * 3 * 256, 9 * rows, 3.125 * rows,
                                        17.5 * rows)
    # the nearest mode's counts: half of 7 + 20 integer ones
    assert pm.sass_ops(rows, pm.QUANTIZE_SASS_A_ROW["nearest"]) == (
        9 * rows, 13.5 * rows, 41 * rows)
    i32, issue = 132 * 64 * 1.98e9, 132 * 128 * 1.98e9
    assert pm.PEAK_I32_OPS_PER_S == {H100: i32}
    assert pm.PEAK_ISSUE_PER_S == {H100: issue}
    ms, by = _bound(pm.quantize(rows))
    assert by == "instruction issue" and ms == 181 * rows / issue * 1e3
    assert _bound(pm.quantize_reduce(rows))[1] == "bytes"
    assert _bound(pm.tree_loop_cond()) == (8 / _HBM * 1e3, "bytes")
    # 1,048,576 rows: ~0.0057 ms of instruction issue, the ALU-only
    # opcodes' 0.0056 under it, the bytes' 0.0034 further
    ms, _ = _bound(pm.quantize(1 << 20))
    assert 0.00566 < ms < 0.00568
    assert 0.00557 < 89 * (1 << 20) / i32 * 1e3 < 0.00559


def test_bound_ms_names_the_largest_term():
    i32, issue = 132 * 64 * 1.98e9, 132 * 128 * 1.98e9
    assert pm.bound_ms(1e9, 0, H100) == pm.bound_ms(1e9, 0, H100, 0.0, 0.0)
    assert pm.bound_ms(1e6, 1e6, H100, 1e9) == (1e9 / i32 * 1e3, "integer operations")
    assert pm.bound_ms(1e6, 1e6, H100, 1e9, 1.5e9) == (1e9 / i32 * 1e3, "integer operations")
    assert pm.bound_ms(1e6, 1e6, H100, 1e9, 3e9) == (3e9 / issue * 1e3, "instruction issue")
    assert pm.bound_ms(1e9, 0, H100, 1e6, 1e6) == (1e9 / _HBM * 1e3, "bytes")
    assert pm.bound_ms(0, 1e12, H100, 1e6, 1e6) == (1e12 / _F32 * 1e3, "operations")
    assert pm.bound_ms(0, 0, H100) == (0.0, "bytes")  # a tie names the first
    assert pm.bound_ms(1e9, 0, "a CPU", 1e9, 1e9) is None


_SASS = """
        Function : _ZN12_GLOBAL__N_115other_kernelEPKf
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0010*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_114toy_kernelEPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   ULDC.64 UR4, c[0x0][0x208] ;
        /*0020*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0030*/                   LDG.E R5, desc[UR4][R2.64+0x4] ;
        /*0040*/                   IMAD.IADD R6, R4, 0x1, R5 ;
        /*0050*/                   LDG.E R8, desc[UR4][R2.64+0x8] ;
        /*0060*/                   LDG.E R9, desc[UR4][R2.64+0xc] ;
        /*0070*/              @!P2 BRA 0xb0 ;
        /*0080*/                   SHF.L.W.U32.HI R6, R6, 0xd, R6 ;
        /*0090*/                   LOP3.LUT R6, R6, R8, RZ, 0x3c, !PT ;
        /*00a0*/                   IADD3 R6, R6, 0x1, R9 ;
        /*00b0*/                   FFMA R7, R6, R4, R5 ;
        /*00c0*/                   STG.E.U8 desc[UR4][R2.64], R7 ;
        /*00d0*/                   ISETP.GE.AND P0, PT, R6, R10, PT ;
        /*00e0*/               @!P0 BRA 0x20 ;
        /*00f0*/                   BRA 0x0 ;
        /*0100*/                   EXIT ;
"""


def test_row_loop_mix_counts_the_innermost_row_loop():
    assert [i for _, i in pm.sass_kernel(_SASS, "other_kernel")][-1] == "EXIT"
    mix = pm.row_loop_mix(_SASS, "toy_kernel", holding="STG")
    assert mix["rows_an_iteration"] == 2  # four loads, two a row
    assert mix["all"] == {"alu_only": 1.5, "integer": 0.5, "alu": 2.0, "imad": 0.5,
                          "float": 0.5, "float_ops": 1.0, "memory": 2.5, "control": 1.0,
                          "uniform": 0.0, "issued": 6.5}
    assert pm.sass_counts(mix["all"]) == {"alu_only": 1.5, "alu": 2.0, "imad": 0.5,
                                          "float_ops": 1.0, "issued": 6.5}
    # the predicated branch skips the SHF, LOP3 and IADD3
    assert mix["skip"]["alu"] == 0.5 and mix["skip"]["alu_only"] == 0.5
    assert mix["skip"]["imad"] == 0.5 and mix["skip"]["issued"] == 5.0
    assert [pm.sass_class(i) for i in ("@P0 IMAD.MOV.U32 R1, RZ, RZ, R2", "ULDC UR4, c[0x0]",
                                       "F2I.TRUNC.NTZ R1, R2", "S2R R0, SR_TID.X",
                                       "LEA.HI R1, R2, 0x3f800000, RZ, 0x17",
                                       "LEA R18, P0, R14, UR8, 0x2", "@!P1 IADD3 R1, R2, 0x1, RZ",
                                       "IADD3.X R1, R1, R8, RZ, PT, PT", "MOV R1, R2",
                                       "LOP3.LUT R6, R6, R8, RZ, 0x3c, !PT",
                                       "SHF.L.W.U32.HI R6, R6, 0xd, R6",
                                       "ISETP.GE.AND P0, PT, R6, R10, PT")] == [
        "imad", "uniform", "float", "control", "alu_only", "integer", "integer", "integer",
        "integer", "alu_only", "alu_only", "alu_only"]
    with pytest.raises(ValueError):
        pm.row_loop_mix(_SASS, "missing_kernel")


@pytest.mark.parametrize("seed", range(3))
def test_row_partition_and_early_stop_block_formulas(seed):
    """The single-pass row partition (row 5a): the index and a bin byte a
    row in, both children over every position and n_left out; the early-
    stopping block (row 1b): the active rows' features, sums read and
    written, the list read and the next written, the two counts, the trees;
    both bound by bytes at the main path's shapes."""
    s = _shapes(seed)
    rows, P, F, T, tables, visits = (s[k] for k in ("rows", "P", "F", "T", "tables", "visits"))
    assert pm.row_partition(rows, P) == (5 * rows + 8 * P + 4, 0.0)
    C, kept = 1 + seed, rows // 3
    assert pm.early_stop_block(rows, F, C, T, tables, visits, kept) == (
        rows * F * 4 + 2 * rows * C * 4 + rows * 4 + kept * 4 + 8 + tables,
        visits + rows * T + rows * C)
    assert pm.early_stop_block(rows, F, C, T, tables, visits) == pm.early_stop_block(
        rows, F, C, T, tables, visits, rows)
    # the root split of 1,048,576 rows, and a block of 10 trees over 1,048,576
    # active rows x 28 features (about 10 node visits a row and tree)
    root, by = pm.bound_ms(*pm.row_partition(1 << 20, 1 << 20), H100)
    assert by == "bytes" and abs(root - (13 * (1 << 20) + 4) / _HBM * 1e3) < 1e-12
    block, by = pm.bound_ms(*pm.early_stop_block(1 << 20, 28, 1, 10, 10 * 5088,
                                                 1e8, 1 << 19), H100)
    assert by == "bytes" and 0.03 < block < 0.05


def test_peak_table_has_the_card_and_no_tpu(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_PEAK_BW_GBPS", raising=False)
    assert pm.peak_bandwidth_bytes_per_s(H100) == _HBM
    assert pm.peak_f32_ops_per_s(H100) == _F32
    # keyed on the full name: the PCIe and NVL parts' rates are not the SXM's
    for kind in ("TPU v4", "TPU v5 lite", "v5e", "v5p", "cpu", "", "NVIDIA H100 PCIe",
                 "NVIDIA H100 NVL", "h100"):
        assert pm.peak_bandwidth_bytes_per_s(kind) is None
        assert pm.bound_ms(1e9, 0, kind) is None
    markers = (list(pm.PEAK_HBM_BYTES_PER_S) + list(pm.PEAK_F32_OPS_PER_S)
               + list(pm.PEAK_I32_OPS_PER_S))
    assert markers == [H100, H100, H100]
    bound = pm.bound_ms(1e9, 1e9, H100)
    monkeypatch.setenv("LGBM_TPU_PEAK_BW_GBPS", "2000")
    assert pm.peak_bandwidth_bytes_per_s("anything") == 2e12
    assert pm.bound_ms(1e9, 1e9, H100) == bound  # the bound ignores the override


def test_learner_gauges():
    assert pm.carry_bytes_per_wave(1000, 28) == 28 * 1000 + 1000 * 5 * 4
    assert pm.hist_bytes_per_row(28) == 28 + 12 + 4
    # the ragged kernel's model over its rows is the gauge times the rows
    assert pm.hist_ragged(1000, 28, 1, 0)[0] == 1000 * pm.hist_bytes_per_row(28)
    assert pm.scan_bytes_per_wave(21, 28, 256) == pm.find_best_split(28, 256, 42)[0]


def test_attribution_fractions_sum_to_one_with_other():
    totals = {"boosting": 0.1, "tree_device": 0.3, "tree_results": 0.9,
              "tree_replay": 0.05, "update_score": 0.02, "tree_stage": 0.01,
              "unrelated": 5.0}
    counters = {"device_waves": 100, "device_carry_bytes_per_wave": 10_000_000,
                "device_hist_rows": 5_000_000, "device_hist_bytes_per_row": 44,
                "device_scan_bytes_per_wave": 1_000_000}
    rep = pm.attribution(totals, counters, total_s=2.0, device_kind=H100)
    assert math.isclose(rep["fractions_sum"], 1.0, abs_tol=1e-9)
    assert math.isclose(rep["stages"]["other"]["wall_s"], 2.0 - 1.37, abs_tol=1e-12)
    grow = rep["stages"]["grow_fused"]
    assert grow["model_bytes"] == 2 * 10_000_000 * 100 + 5_000_000 * 44 + 100_000_000
    assert math.isclose(grow["roofline_frac"], grow["model_bytes"] / _HBM / 1.2)
    # no total given: the covered stages are the whole
    rep = pm.attribution(totals, {}, device_kind="cpu")
    assert "other" not in rep["stages"] and math.isclose(rep["fractions_sum"], 1.0)
    assert "model_bytes" not in rep["stages"]["grow_fused"]


def test_model_bytes_missing_counters_contribute_nothing():
    assert pm.model_bytes_from_counters({}) == {}
    assert pm.model_bytes_from_counters({"device_waves": 3}) == {}


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16hist_rows_kernelPKhPKfPiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z16hist_rows_kernelPKhPKfPiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11split_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z11split_kernelPf
    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers, 2048 bytes smem, 400 bytes cmem[0]
"""


def test_parse_ptxas_and_static_costs():
    got = pm.parse_ptxas(PTXAS)
    assert got["_Z16hist_rows_kernelPKhPKfPiiiii"] == {
        "registers": 40, "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0}
    assert got["_Z11split_kernelPf"] == {
        "registers": 255, "smem_bytes": 2048, "spill_stores": 16, "spill_loads": 24}

    class Lib:
        ptxas = PTXAS

        class source:
            name = "unit.cu"

    assert pm.static_costs([Lib]) == {"unit.cu": got}


def test_note_dispatch_keeps_the_first_signature():
    import torch

    pm.reset_dispatches()
    pm.note_dispatch("unit", test_note_dispatch_keeps_the_first_signature,
                     torch.zeros(3, 4), 7, flag=True)
    pm.note_dispatch("unit", len, torch.zeros(1))
    sig = pm.dispatch_signature("unit")
    assert sig["args"] == [[[3, 4], "torch.float32"], 7] and sig["kwargs"] == {"flag": True}
    assert pm.captured_stages() == ["unit"]
    pm.reset_dispatches()
