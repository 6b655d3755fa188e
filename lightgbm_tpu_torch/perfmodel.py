"""Cost model: every kernel's bytes and operations, and attribution.

Counterpart of the JAX package's ``perfmodel.py``, for the port's own
kernels and buffers. It is the one source of the work each kernel does:

  * **Formulas as code.** One function for each kernel of PERF.md §6's
    table returns ``(bytes, operations)``: the bytes the kernel must move
    (each input read once, each output written once) and the operations it
    does on them. `bound_ms` turns a pair into the least time the card
    could take, the larger of bytes over the memory rate and operations
    over the float32 peak, from the peak table alone. `chip_smoke.py` reads its bound column from
    here, so a roofline reads the same work whatever implements it.
  * **The learners' gauges.** `carry_bytes_per_wave`, `hist_bytes_per_row`
    and `scan_bytes_per_wave` describe the wave learner's buffers (the
    carry a wave's partition reads and writes, the ragged histogram's read
    of a row, the split kernel's read of a wave's children); the learner
    publishes them through `global_timer` and `model_bytes_from_counters`
    reads them back.
  * **Static costs.** The CUDA kernels have no XLA ``cost_analysis``: what
    the compiler reports of them is ptxas's registers, shared memory and
    spills a kernel, which ``ops/cuda_build.py`` captures at each build
    (``-Xptxas -v``). `static_costs()` parses them. `note_dispatch` records
    the first dispatch of each instrumented stage (name and shapes).
  * **Attribution.** `attribution()` merges measured per-stage walls (timer
    totals), the byte model and the card's peak rate into a report: each
    stage's fraction of the wall (the fractions sum to 1, the residual an
    explicit "other" stage), its model seconds and the roofline fraction it
    reached.

The peak table has the cards the port runs on, each keyed by its full
name as torch.cuda.get_device_name gives it (an H100 PCIe or NVL card has
other rates than the SXM part's and is not in it), with the host link's
rate beside them for the streamed learner's uploads. LGBM_TPU_PEAK_BW_GBPS
overrides the memory rate of `peak_bandwidth_bytes_per_s` and so of
`attribution`'s roofline, never `bound_ms`. The wire's bytes a wave of the
distributed learners (`ici_bytes_per_wave`, `voting_`, `feature_` and
`stream_ici_bytes_per_wave`) are the JAX package's formulas with the
port's collectives.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# The card's peak rates
# ---------------------------------------------------------------------------

# peak device-memory bytes/s and float32 operations/s (outside the tensor
# cores), keyed by torch.cuda.get_device_name: the H100 SXM part's data
# sheet rates at its 700 W limit
PEAK_HBM_BYTES_PER_S: Dict[str, float] = {"NVIDIA H100 80GB HBM3": 3.35e12}
PEAK_F32_OPS_PER_S: Dict[str, float] = {"NVIDIA H100 80GB HBM3": 67e12}
# host-to-card bytes/s, one direction: the H100 SXM5 data sheet's PCIe Gen5
# x16, 64 GB/s a direction (the streamed learner's block uploads)
PEAK_HOST_LINK_BYTES_PER_S: Dict[str, float] = {"NVIDIA H100 80GB HBM3": 64e9}


def peak_bandwidth_bytes_per_s(device_kind: str = "") -> Optional[float]:
    """Peak device-memory bytes/s of a card, or None when unknown (the CPU
    has no roofline). $LGBM_TPU_PEAK_BW_GBPS overrides."""
    env = os.environ.get("LGBM_TPU_PEAK_BW_GBPS", "")
    if env:
        try:
            return float(env) * 1e9
        except ValueError:
            pass
    return PEAK_HBM_BYTES_PER_S.get(device_kind)


def peak_f32_ops_per_s(device_kind: str = "") -> Optional[float]:
    """Peak float32 operations/s of a card, or None when unknown."""
    return PEAK_F32_OPS_PER_S.get(device_kind)


def bound_ms(nbytes: float, ops: float, device_kind: str) -> Optional[Tuple[float, str]]:
    """The least time the card could take for (bytes, operations): the
    larger of bytes over the memory rate and operations over the float32
    peak, in ms, and which of the two it is ("bytes" or "operations").
    The rates come from the table alone, never the environment's override.
    None for a device the table does not know."""
    bw, fl = PEAK_HBM_BYTES_PER_S.get(device_kind), PEAK_F32_OPS_PER_S.get(device_kind)
    if bw is None or fl is None:
        return None
    t_bytes, t_ops = nbytes / bw * 1e3, ops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def h2d_bound_ms(nbytes: float, device_kind: str) -> Optional[float]:
    """The least time the host link could take to upload `nbytes`, in ms
    (the table's rate; None for a device it does not know)."""
    rate = PEAK_HOST_LINK_BYTES_PER_S.get(device_kind)
    return None if rate is None else nbytes / rate * 1e3


def shared_memory_per_block(device=None) -> int:
    """The card's opt-in shared memory a block (the counterpart of the
    TPU's VMEM budget), from torch.cuda.get_device_properties; 0 with no
    card."""
    import torch

    if not torch.cuda.is_available():
        return 0
    props = torch.cuda.get_device_properties(device if device is not None else 0)
    return int(getattr(props, "shared_memory_per_block_optin",
                       getattr(props, "shared_memory_per_block", 0)))


# ---------------------------------------------------------------------------
# PERF.md §6, row by row: (bytes, operations) of one launch
# ---------------------------------------------------------------------------

# the split record: 14 float32 fields (ops/split.py)
REC_FIELDS = 14
# the wave carry's payload: gh (3 channels), position and leaf id, 4 B each
PAYLOAD_COLS = 5


def traversal_raw(rows: int, n_features: int, n_trees: int, table_bytes: int,
                  node_visits: float, n_outputs: int = 1) -> Tuple[float, float]:
    """Row 1, raw mode: the rows and the node tables read once, a score a
    (row, output) written; a compare a node visited and an add a tree."""
    return (rows * n_features * 4 + rows * n_outputs * 4 + table_bytes,
            node_visits + rows * n_trees)


def traversal_accumulate(rows: int, n_features: int, n_trees: int, table_bytes: int,
                         node_visits: float) -> Tuple[float, float]:
    """Row 1b, the raw mode adding onto running sums: the sums read and
    written besides the rows and tables."""
    return (rows * n_features * 4 + 2 * rows * 4 + table_bytes,
            node_visits + rows * n_trees)


def traversal_leaf(rows: int, n_features: int, n_trees: int, table_bytes: int,
                   node_visits: float) -> Tuple[float, float]:
    """Row 1, leaf mode: a leaf index a (row, tree) written; a compare a
    node visited."""
    return rows * n_features * 4 + rows * n_trees * 4 + table_bytes, node_visits


def linear_score(rows: int, n_features: int, slots: int, mean_depth: float,
                 table_bytes: int) -> Tuple[float, float]:
    """Row 1 on the linear path: the rows read once, a score written; a
    compare a level, two operations a linear term, the constant's add."""
    return (rows * n_features * 4 + rows * 4 + table_bytes,
            rows * (mean_depth + 2 * slots + 1))


def hist_ragged(rows: int, n_groups: int, n_outputs: int,
                out_bytes: int) -> Tuple[float, float]:
    """Row 2 (and row 6, over every row with `n_outputs` slots): a row's
    bin bytes, the payload's three float columns and its slot read once
    over the rows in the ranges, each output histogram written; three adds
    a (row, group)."""
    return rows * (n_groups + 12 + 4) + n_outputs * out_bytes, 3 * n_groups * rows


def stream_block_bytes(block_rows: int, n_groups: int, plane_bytes: int = 1) -> int:
    """Upload bytes of one streamed bin block (streaming/learner.py): the
    [G, block_rows] slab, G * block_rows * plane_bytes (the last block has
    fewer rows)."""
    return int(n_groups) * int(block_rows) * int(plane_bytes)


def hist_rows(rows: int, n_groups: int, out_bytes: int,
              gh_bytes: int = 12) -> Tuple[float, float]:
    """Row 5: the bins, the gh row (12 B float, 3 B int8) and the index
    read once over the leaf's rows, the histogram written; three adds a
    (row, group)."""
    return rows * (n_groups + gh_bytes + 4) + out_bytes, 3 * n_groups * rows


def compact_rows(rows: int, n_groups: int) -> Tuple[float, float]:
    """Row 3, compact_rows: the plane and the 5-column payload read and
    written, the destinations read."""
    return 2 * (n_groups + PAYLOAD_COLS * 4) * rows + 4 * rows, 0.0


def partition_decide(rows: int, payload_cols: int, tiles: int,
                     ranges: int) -> Tuple[float, float]:
    """Row 3, the wave partition's decide pass: the leaf id (its payload
    row's sectors) and a bin byte in, a bit and the tile's counts out."""
    return rows * (4 * payload_cols + 1) + rows / 8 + tiles * ranges * 4, 0.0


def partition_scan(tiles: int, ranges: int) -> Tuple[float, float]:
    """Row 3, the scan pass: the counts in and the offsets out, the tables,
    the children out."""
    return 2 * tiles * ranges * 4 + 3 * ranges * 4 + ranges * (3 * 4 + 2 + 4), 0.0


def partition_scatter(rows: int, n_groups: int, payload_cols: int, tiles: int,
                      ranges: int) -> Tuple[float, float]:
    """Row 3, the scatter pass: the plane and the payload in and out, the
    slot out, the bits in."""
    return (2 * rows * (n_groups + 4 * payload_cols) + 4 * rows + rows / 8
            + tiles * ranges * 4, 0.0)


def relabel(rows: int) -> Tuple[float, float]:
    """Row 3, the commit's relabel: a leaf id written a relabeled row."""
    return 4 * rows, 0.0


def split_scan(n_features: int, max_bins: int) -> Tuple[float, float]:
    """Row 4, the per-feature form on one leaf: the feature histogram, its
    validity bytes, metadata, params and totals read, a record a feature
    written; two leaf gains and gates a (feature, bin, lane)."""
    F, B = n_features, max_bins
    return (F * B * 3 * 4 + F * B + F * 14 + 6 * 4 + 3 * 4 + F * 14 * 4,
            F * B * 2 * 30)


def split_scan_batched(leaves: int, n_features: int, max_bins: int) -> Tuple[float, float]:
    """Row 4, the per-feature form on a batch of leaves (the tables once)."""
    L, F, B = leaves, n_features, max_bins
    return (L * (F * B * 3 * 4 + 3 * 4 + F * 14 * 4) + F * B + F * 14 + 6 * 4,
            L * F * B * 2 * 30)


def find_best_split(n_features: int, max_bins: int, leaves: int = 1,
                    quantized: bool = False,
                    constrained: bool = False) -> Tuple[float, float]:
    """Row 4, the find form (group histogram -> each leaf's record): a
    leaf's feature bins, totals and record (int32 bins with the scale when
    quantized), the gather index, valid slots and metadata once (the
    output bounds' two bytes a feature more when constrained). Operations a
    (leaf, feature, bin, lane): 30, 31 with the scale's multiply, 48
    constrained (clamped outputs, the direction test, the gains from
    them)."""
    F, B = n_features, max_bins
    per_leaf = F * B * 12 + 3 * 4 + REC_FIELDS * 4 + (3 * 4 if quantized else 0)
    tables = F * B * 9 + F * 4 * 4 + (2 * F if constrained else F) + 6 * 4
    per_lane = 48 if constrained else (31 if quantized else 30)
    return leaves * per_leaf + tables, leaves * F * B * 2 * per_lane


def row_partition_decide(rows: int, tiles: int) -> Tuple[float, float]:
    """Row 5a, decide: the index and a bin byte in, a bit and the tile's
    count out."""
    return rows * (4 + 1) + rows / 8 + tiles * 4, 0.0


def row_partition_scatter(rows: int, tiles: int, positions: int) -> Tuple[float, float]:
    """Row 5a, scatter: the index, the bits and the counts in, both
    children out."""
    return rows * 4 + rows / 8 + tiles * 4 + 2 * 4 * positions + 4, 0.0


def wave_select(leaves: int, width: int, table_words: int) -> Tuple[float, float]:
    """Row 2a: the L gains; of each selected leaf its record's feature,
    threshold and default_left, its start and count, its feature's six
    int32 fields and is_efb byte; the done word; the table written."""
    L, K = leaves, width
    return L * 4 + K * (3 * 4 + 2 * 4 + 6 * 4 + 1) + 8 + table_words * 4, 0.0


def wave_replay(leaves: int, width: int, commits: int) -> Tuple[float, float]:
    """Row 2b. In: the L gains, the K parents' depths, the table's starts,
    counts, valid flags and leaf ids, the left counts, the 2K children's
    gains, hessians and counts, five regularizers, the scalars; for each
    commit the rest of both children's records, their gradients and the
    parent's record. Out: the committed records, depths, split-log rows,
    starts and counts, the commit table and the scalars."""
    from .ops.wave import REC, SCALARS, STORE

    L, K, n = leaves, width, commits
    return (L * 4 + K * 4 + 4 * K * 4 + K * 4 + 2 * K * 3 * 4 + 5 * 4 + SCALARS * 8
            + n * (2 * (REC - 1) * 4 + 2 * 4 + REC * 4)
            + n * (2 * REC * 4 + 2 * 4 + STORE * 4 + 3 * 4) + 5 * K * 8
            + SCALARS * 8, 0.0)


def tree_loop_cond() -> Tuple[float, float]:
    """Row 2c: the done word and the pass count read, the count written."""
    return 3 * 8, 0.0


def quantize_reduce(rows: int) -> Tuple[float, float]:
    """Row Q, the reduce pass: g and h read once, the per-block maxima
    written; three operations a row."""
    return 8 * rows + 4 * 3 * 256, 3 * rows


def quantize(rows: int) -> Tuple[float, float]:
    """Row Q, the quantize pass: g and h read, the int8 (g, h, 1) rows and
    the scale written; six operations a row."""
    return 8 * rows + 3 * (rows + 1) + 12 + 4 * 3 * 256, 6 * rows


# ---------------------------------------------------------------------------
# The wave learner's gauges
# ---------------------------------------------------------------------------


def carry_bytes_per_wave(n_rows: int, n_groups: int, plane_bytes: int = 1,
                         payload_cols: int = PAYLOAD_COLS) -> int:
    """Bytes of one copy of the wave carry (treelearner/device.py
    WaveBuffers): the [G, N] bin plane and the [N, 5] float32 payload. A
    wave's partition reads one copy and writes the other (the scatter's
    0.055 ms of a no-op wave's fixed cost, PERF.md §5)."""
    return int(n_groups) * int(n_rows) * int(plane_bytes) + int(n_rows) * int(payload_cols) * 4


def hist_bytes_per_row(n_groups: int, plane_bytes: int = 1, ch: int = 3) -> int:
    """Bytes the ragged histogram (hist_ragged_kernel) reads a histogrammed
    row: its bin-plane column, the payload's gh channels and its slot."""
    return int(n_groups) * int(plane_bytes) + int(ch) * 4 + 4


def scan_bytes_per_wave(wave_width: int, n_features: int, max_bins: int,
                        quantized: bool = False) -> int:
    """Bytes the split kernel (split_kernel, find form) moves a wave: the
    2K children's feature histograms and records, the tables once."""
    return int(find_best_split(n_features, max_bins, 2 * int(wave_width), quantized)[0])


# ---------------------------------------------------------------------------
# Dispatch capture and static costs
# ---------------------------------------------------------------------------

_dispatches: Dict[str, Dict[str, Any]] = {}


def _shape_of(x: Any) -> Any:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        return x if isinstance(x, (int, float, bool, str, type(None))) else type(x).__name__
    return [list(shape), str(dtype)]


def note_dispatch(stage: str, fn: Any, *args: Any, **kwargs: Any) -> None:
    """Record an instrumented stage's first dispatch: the function's name
    and its arguments' shapes and dtypes. After the first, a dict check.
    Call sites guard it behind telemetry.enabled()."""
    if stage in _dispatches:
        return
    _dispatches[stage] = {
        "fn": getattr(fn, "__qualname__", str(fn)),
        "args": [_shape_of(a) for a in args],
        "kwargs": {k: _shape_of(v) for k, v in kwargs.items()},
    }


def captured_stages() -> List[str]:
    return sorted(_dispatches)


def dispatch_signature(stage: str) -> Optional[Dict[str, Any]]:
    return _dispatches.get(stage)


def reset_dispatches() -> None:
    _dispatches.clear()


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(report: str) -> Dict[str, Dict[str, int]]:
    """ptxas -v's report -> {kernel: {registers, smem_bytes, spill_stores,
    spill_loads}} (the mangled entry names as ptxas prints them)."""
    out: Dict[str, Dict[str, int]] = {}
    current: Optional[str] = None
    for line in report.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            current = m.group(1)
            out[current] = {"registers": 0, "smem_bytes": 0, "spill_stores": 0,
                            "spill_loads": 0}
            continue
        if current is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            out[current]["registers"] = int(m.group(1))
            m = _PTXAS_SMEM.search(line)
            if m:
                out[current]["smem_bytes"] = int(m.group(1))
    return out


def static_costs(libraries=None) -> Dict[str, Dict[str, Dict[str, int]]]:
    """Each built kernel's registers, static shared memory and spills, from
    the ptxas reports of this process's builds (ops/cuda_build.py), by
    source file. Sources not built in this process are absent."""
    from .ops import cuda_build

    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for lib in (libraries if libraries is not None else cuda_build._LIBRARIES):
        report = getattr(lib, "ptxas", "")
        if report:
            out[lib.source.name] = parse_ptxas(report)
    return out


# ---------------------------------------------------------------------------
# Attribution: measured walls x the byte model x the card's peak
# ---------------------------------------------------------------------------

# stage -> the timer labels whose totals it owns: leaf scopes of the
# training loop, never one nested in another listed one, so stage walls are
# disjoint and the fractions sum to 1. `grow_fused` is the wave learner's
# tree: its launch (`tree_device`; a sharded learner's host-driven loop,
# `tree_sharded`) and the host's wait for its results (`tree_results`),
# where the card's time shows on the host clock.
STAGE_LABELS: Dict[str, Tuple[str, ...]] = {
    "gradients": ("boosting",),
    "grow_fused": ("tree_device", "tree_sharded", "tree_results"),
    "histogram": ("hist_root", "hist_children", "hist_recompute"),
    "scan": ("find_best_split",),
    "partition": ("partition",),
    "replay": ("tree_replay",),
    "score_update": ("update_score",),
    "bagging": ("bagging",),
    "linear_fit": ("linear_fit",),
}

ATTRIBUTION_SCHEMA_VERSION = 1


def model_bytes_from_counters(counters: Mapping[str, int]) -> Dict[str, int]:
    """Total model bytes a stage for one run, from the gauges and counters
    the wave learner publishes:

      compact    2 x carry x waves    (the partition reads AND writes it)
      histogram  hist_rows x bytes/row  (the ragged kernel's rows)
      scan       scan_bytes x waves
      stream_h2d the streamed learner's uploads, counted as they are made
                 (blocks x stream_block_bytes + the partition's group rows)

    Missing counters contribute nothing: a serial-learner run yields an
    empty model and the attribution is the measured fractions alone."""
    waves = int(counters.get("device_waves", 0))
    out: Dict[str, int] = {}
    carry = int(counters.get("device_carry_bytes_per_wave", 0))
    if carry and waves:
        out["compact"] = 2 * carry * waves
    hist_rows_n = int(counters.get("device_hist_rows", 0))
    row_bytes = int(counters.get("device_hist_bytes_per_row", 0))
    if hist_rows_n and row_bytes:
        out["histogram"] = hist_rows_n * row_bytes
    scan = int(counters.get("device_scan_bytes_per_wave", 0))
    if scan and waves:
        out["scan"] = scan * waves
    h2d = int(counters.get("stream_h2d_bytes", 0))
    if h2d:
        out["stream_h2d"] = h2d
    return out


def attribution(totals: Mapping[str, float], counters: Mapping[str, int],
                total_s: Optional[float] = None, device_kind: str = "",
                include_static: bool = False) -> Dict[str, Any]:
    """Per-stage attribution report.

    totals:   timer label -> accumulated seconds (global_timer.totals or a
              telemetry session_end's ``timer_totals``)
    counters: the run's counters (for the byte model)
    total_s:  the wall to attribute against (the run's training wall);
              defaults to the stages' covered sum
    Returns ``{"stages": {name: {...}}, "fractions_sum": 1.0, ...}``; every
    stage has ``wall_s`` and ``fraction``, the device stage also
    ``model_bytes``, ``model_s``, ``drift_pct`` and ``roofline_frac`` when
    the byte model and the peak table cover it."""
    walls: Dict[str, float] = {}
    for stage, labels in STAGE_LABELS.items():
        w = sum(float(totals.get(lbl, 0.0)) for lbl in labels)
        if w > 0.0:
            walls[stage] = w
    covered = sum(walls.values())
    if total_s is None or total_s <= 0.0 or covered > total_s:
        total_s = covered
    model = model_bytes_from_counters(counters)
    bw = peak_bandwidth_bytes_per_s(device_kind)
    stages: Dict[str, Dict[str, Any]] = {}
    for stage, wall in sorted(walls.items(), key=lambda kv: -kv[1]):
        entry: Dict[str, Any] = {"wall_s": wall,
                                 "fraction": wall / total_s if total_s else 0.0}
        comp = {k: v for k, v in model.items() if k != "stream_h2d"}
        if stage == "grow_fused" and comp:
            # the fused device stage owns every on-card component
            entry["model_components_bytes"] = comp
            entry["model_bytes"] = sum(comp.values())
            _add_model_seconds(entry, entry["model_bytes"], wall, bw)
        stages[stage] = entry
    other = max(total_s - covered, 0.0)
    if total_s > 0.0 and other > 0.0:
        stages["other"] = {"wall_s": other, "fraction": other / total_s}
    if "stream_h2d" in model:
        # the streamed learner's uploads run on a copy stream beside the
        # histograms, inside stages already counted: fraction 0, out of the
        # closure; their time is the copy stream's (stream_h2d_us), against
        # the host link's rate
        h2d_wall = float(counters.get("stream_h2d_us", 0)) / 1e6
        entry = {"wall_s": h2d_wall, "fraction": 0.0, "overlapped": True,
                 "model_bytes": model["stream_h2d"]}
        _add_model_seconds(entry, model["stream_h2d"], h2d_wall,
                           PEAK_HOST_LINK_BYTES_PER_S.get(device_kind))
        stages["stream_h2d"] = entry
    report: Dict[str, Any] = {
        "schema_version": ATTRIBUTION_SCHEMA_VERSION,
        "total_s": total_s,
        "covered_s": covered,
        "stages": stages,
        "fractions_sum": sum(s["fraction"] for s in stages.values()) if stages else 0.0,
    }
    if bw is not None:
        report["peak_bw_bytes_per_s"] = bw
    if include_static:
        static = static_costs()
        if static:
            report["static"] = static
    return report


def _add_model_seconds(entry: Dict[str, Any], model_bytes: int, wall_s: float,
                       bw: Optional[float]) -> None:
    """Model seconds at the peak rate, measured-vs-model drift, and the
    roofline fraction the stage reached."""
    if not bw or model_bytes <= 0:
        return
    model_s = model_bytes / bw
    entry["model_s"] = model_s
    if wall_s > 0.0:
        entry["drift_pct"] = (wall_s / model_s - 1.0) * 100.0
        entry["roofline_frac"] = model_s / wall_s


# --------------------------------------------------- the distributed wire
# Bytes one rank hands the collectives in one wave of the sharded wave
# learners (parallel/wave_learners.py), the counterparts of the JAX
# package's perfmodel.py:105-135 with the port's collectives: `value_bytes`
# is 8 for the card's fixed-point image, 4 for int32 (and the CPU's
# float32), 2 for the packed int16 wire. None of them scales with the row
# count.

def ici_bytes_per_wave(wave_width: int, f_pad: int, max_bins: int, group_bins: int,
                       n_shards: int, ch: int = 3, value_bytes: int = 8) -> int:
    """Data-parallel: the [K] int64 left counts, the reduce-scatter of the
    [K, F_pad, Bmax, CH] smaller children's image with their group-0 slice
    [K, Bg, CH] (the leaves' totals) copied into each of the n blocks, and
    the all-gather of this rank's [2K, F_pad / n, REC] block records."""
    k, n = int(wave_width), int(n_shards)
    chunk = (int(f_pad) // n) * k * int(max_bins) * int(ch) + k * int(group_bins) * int(ch)
    return (n * _wire_values(chunk, value_bytes) + 8 * k
            + 2 * k * (int(f_pad) // n) * REC_FIELDS * 4)


def _wire_values(count: int, value_bytes: int) -> int:
    """Bytes of `count` values on the wire: the packed int16 wire carries
    them in pairs, an int32 word each (dist.pack_int16_pairs)."""
    if value_bytes == 2:
        return 4 * (-(-int(count) // 2))
    return int(count) * int(value_bytes)


def voting_ici_bytes_per_wave(wave_width: int, k_local: int, k_global: int,
                              max_bins: int, group_bins: int, ch: int = 3,
                              value_bytes: int = 8) -> int:
    """Voting (PV-Tree): the [K] int64 left counts, the all-gather of this rank's
    [2K, k_local] nominations (int64) and the all-reduce of the [2K,
    k_global, Bmax, CH] elected slices with the children's group-0 slices.
    No term scales with the feature count."""
    k = int(wave_width)
    return (8 * k + 2 * k * int(k_local) * 8
            + _wire_values(2 * k * (int(k_global) * int(max_bins) + int(group_bins)) * int(ch),
                           value_bytes))


def feature_ici_bytes_per_wave(wave_width: int) -> int:
    """Feature-parallel: rows are replicated, so the only traffic is the
    all-gather of this rank's [2K, REC] best records, independent of the
    row and the feature count."""
    return 2 * int(wave_width) * REC_FIELDS * 4


def stream_ici_bytes_per_wave(n_groups: int, group_bins: int, ch: int = 3,
                              value_bytes: int = 8) -> int:
    """The gang-sharded streamed learner (streaming/sharded.py): each leaf
    histogram is one all-reduce of this rank's [G, Bg, CH] image (int64
    fixed point on the card, int32 quantized, float32 on the CPU), whatever
    the row count; the flag words cross only when a rank holds a
    non-finite gh."""
    return int(n_groups) * int(group_bins) * int(ch) * int(value_bytes)


def hist_ragged_image(rows: int, n_groups: int, cells: int) -> Tuple[float, float]:
    """Row 2's image mode: row 2's reads, and the image written once, an
    int64 sum and an int32 flag word a cell."""
    return rows * (n_groups + 12 + 4) + 12 * cells, 3 * n_groups * rows


def image_to_float(cells: int) -> Tuple[float, float]:
    """The conversion of an image: an int64 sum and an int32 flag word read
    and a float32 written a cell; one conversion and one scale a cell."""
    return 16 * cells, 2 * cells
