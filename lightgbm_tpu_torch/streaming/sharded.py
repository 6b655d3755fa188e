"""Gang-sharded streaming: sharded ingest, merged drift, and the streamed
learner whose block cache spans the gang (the JAX package's
``streaming/sharded.py``).

* `ShardedRowBlockStore` places pushed row blocks round robin over the
  shards, pinned at push (block i on shard ``i % shards``); the push
  surface is the base store's. The bin layout is fitted from exact
  per-shard quantile sketches of the prefix merged across the ranks in
  rank order (drift.merge_ranked) after one all-gather of byte payloads:
  the merged multiset is put back into a surrogate prefix (sorted values
  scattered to the true nonzero positions) and fed through the same
  `Dataset._fit_layout` a one-shot build runs, so the cut points and the
  EFB groups are the raw-prefix fit's, whichever shard saw which rows.
* `PodDriftMonitor` keeps a sketch and an occupancy window per shard and
  merges them across the ranks at every drift check, so alarms and the bin
  refresh are the same on every rank; `reshard` keeps retired shards'
  state (only the merge is observable).
* `ShardedStreamedTreeLearner` (tree_learner=data under
  LGBM_TPU_HBM_BUDGET): rank r's block cache holds only the blocks it owns
  (b % world == r), up to the single-card budget, so the gang holds world
  times the budget. Every rank keeps the whole partition (the chosen
  group's [N] row is uploaded on every rank at a split, as on one card);
  a leaf's histogram is the leaf histogram kernel's carried mode over the
  rank's own runs of the leaf's rows, the int64 image left unconverted,
  the images all-reduced exactly (every rank holds the whole gh, so the
  tree's exponents are the single card's) and converted once: on the card
  the model is the single-card streamed model's on any gradients. The
  integer mode adds int32; on the CPU the plain versions add float32
  (exact on grid-snapped gradients). The train score walks each rank's own blocks and sums the
  per-row values over the ranks.

The transport is parallel/dist.py: `_allgather_bytes` gathers the payload
lengths, then the payloads padded to the longest as uint8.
"""
from __future__ import annotations

import io as _io
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import perfmodel, telemetry
from ..io.dataset import Dataset as CoreDataset
from ..ops.hist_cuda import HistogramCarry
from ..ops.histogram import HistImage, build_histogram_rows, image_to_float
from ..ops.score import binned_leaf_index, binned_tree_arrays
from ..parallel import dist
from ..parallel.mesh import World, data_world
from ..parallel.wave_learners import decode_flags, encode_flags
from ..utils.log import Log
from ..utils.timer import global_timer
from .drift import DriftMonitor, QuantileSketch, merge_ranked
from .ingest import RowBlockStore
from .learner import StreamedTreeLearner, _BlockCache, block_runs


# --------------------------------------------------------- gang transport

def _gang() -> Optional[World]:
    world = dist.current_world()
    return world if world is not None and world.size > 1 else None


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's byte payload, in rank order (alone: [payload])."""
    world = _gang()
    if world is None:
        return [payload]
    n = torch.tensor([len(payload)], dtype=torch.int64, device=world.device)
    lengths = dist.host_value(dist.all_gather(world, n)).reshape(-1)
    buf = torch.zeros(int(lengths.max()), dtype=torch.uint8)
    buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    rows = dist.host_value(dist.all_gather(world, buf.to(world.device)))
    return [rows[r, :int(lengths[r])].tobytes() for r in range(world.size)]


def _pack_arrays(arrays: Dict[str, np.ndarray]) -> bytes:
    out = _io.BytesIO()
    np.savez(out, **arrays)
    return out.getvalue()


def _unpack_arrays(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(_io.BytesIO(payload), allow_pickle=False) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def _sketch_to_arrays(sk: QuantileSketch, prefix: str, arrays: Dict[str, np.ndarray]) -> None:
    arrays[prefix + "meta"] = np.array(
        [sk.k, sk.nonzero_n, sk.zero_n, sk.nan_n, sk._parity, len(sk.levels)], dtype=np.int64)
    for i, lv in enumerate(sk.levels):
        arrays[f"{prefix}lv{i}"] = np.asarray(lv, dtype=np.float64)


def _sketch_from_arrays(prefix: str, arrays: Dict[str, np.ndarray]) -> Optional[QuantileSketch]:
    meta = arrays.get(prefix + "meta")
    if meta is None:
        return None
    k, nonzero_n, zero_n, nan_n, parity, n_levels = (int(v) for v in meta)
    sk = QuantileSketch(k)
    sk.levels = [np.asarray(arrays[f"{prefix}lv{i}"], dtype=np.float64)
                 for i in range(n_levels)]
    sk.nonzero_n, sk.zero_n, sk.nan_n = nonzero_n, zero_n, nan_n
    sk._parity = parity
    return sk


# ------------------------------------------------------------- pod drift

class PodDriftMonitor(DriftMonitor):
    """DriftMonitor fanned out a shard, merged across the ranks in rank
    order.

    Blocks go to the shard monitors in step with the store's round-robin
    placement; the pod keeps the check cadence. At each check (and each
    refit) the shard sketches fold through drift.merge_ranked and the shard
    occupancy windows sum in rank order, so the merged state, and every
    alarm and refreshed cut point made from it, is a function of the pushed
    stream alone, the same on every rank and in every rerun."""

    def __init__(self, proto: DriftMonitor, num_shards: int) -> None:
        super().__init__(proto.config, sorted(proto.categorical), threshold=proto.threshold,
                         check_rows=proto.check_rows, sketch_k=proto.sketch_k)
        self.num_shards = max(1, int(num_shards))
        self._children: List[DriftMonitor] = []
        self.reshard(self.num_shards)
        self._push_i = 0

    def observe(self, block: np.ndarray, layout) -> None:
        child = self._children[self._push_i % self.num_shards]
        self._push_i += 1
        child.observe(block, layout)
        self._merged_dirty = True
        if layout is not None:
            self._layout = layout
            self._rows_since_check += block.shape[0]
            if self._rows_since_check >= self.check_rows:
                self._merge_shards()
                self._check()

    def set_reference(self, layout, prefix: np.ndarray) -> None:
        super().set_reference(layout, prefix)
        for child in self._children:
            # the children never check: the reference's keys only decide
            # which features their occupancy windows count
            child.set_reference(layout, prefix)

    def after_refresh(self, layout) -> None:
        self._merge_shards()
        super().after_refresh(layout)
        for child in self._children:
            child.after_refresh(layout)

    def refit_mapper(self, j: int, mapper):
        self._merge_shards()
        nm = super().refit_mapper(j, mapper)
        if j < len(self.sketches) and self.sketches[j] is not None \
                and self.sketches[j].nonzero_n == 0:
            # the merged sketch was discarded as corrupt: drop the shard
            # copies too, or the garbage merges back at the next check
            for child in self._children:
                if j < len(child.sketches) and child.sketches[j] is not None \
                        and not child.sketches[j].healthy():
                    child.sketches[j] = QuantileSketch(self.sketch_k)
        return nm

    def reshard(self, num_shards: int) -> None:
        """Future blocks route over `num_shards`; retired shards keep what
        they accumulated (only the rank-ordered merge is observable)."""
        self.num_shards = max(1, int(num_shards))
        while len(self._children) < self.num_shards:
            self._children.append(DriftMonitor(self.config, sorted(self.categorical),
                                               threshold=self.threshold, check_rows=2 ** 62,
                                               sketch_k=self.sketch_k))
        self._merged_dirty = True

    def _shard_payload(self, shard: int) -> bytes:
        child = self._children[shard]
        arrays: Dict[str, np.ndarray] = {"rank": np.array([shard])}
        for j, sk in enumerate(child.sketches):
            if sk is not None:
                _sketch_to_arrays(sk, f"sk{j}_", arrays)
        for j, cur in child._cur.items():
            arrays[f"cur{j}"] = np.asarray(cur, dtype=np.float64)
        return _pack_arrays(arrays)

    def _merge_shards(self) -> None:
        """Fold the shard sketches and occupancy windows into the pod's own
        state, in rank order. In a gang rank r holds shard r and one
        all-gather rebuilds the set everywhere; alone the gather is a walk
        over the children."""
        if not self._merged_dirty:
            return
        world = _gang()
        t0 = perf_counter()
        if world is not None:
            payloads = _allgather_bytes(self._shard_payload(world.rank % self.num_shards))
        else:
            payloads = [self._shard_payload(r) for r in range(self.num_shards)]
        shards = [_unpack_arrays(p) for p in payloads]
        n_feat = max((len(c.sketches) for c in self._children), default=0)
        merged: List[Optional[QuantileSketch]] = []
        for j in range(n_feat):
            pairs = [(int(a["rank"][0]), sk) for a in shards
                     for sk in [_sketch_from_arrays(f"sk{j}_", a)] if sk is not None]
            merged.append(merge_ranked(pairs) if pairs else None)
        self.sketches = merged
        for j in list(self._cur):
            acc = np.zeros_like(self._cur[j])
            for arrays in shards:  # rank order
                cur = arrays.get(f"cur{j}")
                if cur is not None:
                    acc += cur
            self._cur[j] = acc
        self._merged_dirty = False
        global_timer.set_count("stream_sketch_merge_us", int((perf_counter() - t0) * 1e6))
        global_timer.add_count("stream_sketch_merges", 1)


# ---------------------------------------------------------- sharded store

class ShardedRowBlockStore(RowBlockStore):
    """RowBlockStore with round-robin block placement over a gang: every
    block is binned into the same global plane in push order (finalize()
    is the single-shard build's), with the placement pinned at push and
    its per-shard watermarks (`shard_rows`), the layout fit from
    rank-merged sketches, the PodDriftMonitor, and `reshard` after the
    gang shrank. The shard count is `num_shards`, else the joined gang's
    size, else 1."""

    def __init__(self, *args, num_shards: Optional[int] = None, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._num_shards_req = num_shards
        self._num_shards: Optional[int] = None
        self._block_owner: List[int] = []
        self._block_nrows: List[int] = []
        if self._drift is not None:
            self._drift = PodDriftMonitor(self._drift, self.num_shards)

    @property
    def num_shards(self) -> int:
        if self._num_shards is None:
            world = _gang()
            self._num_shards = (max(1, int(self._num_shards_req))
                                if self._num_shards_req is not None
                                else world.size if world is not None else 1)
        return self._num_shards

    def push_rows(self, data, label=None, weight=None):
        arr = np.asarray(data)
        rows = arr.shape[0] if arr.ndim == 2 else 1
        with self._lock:
            self._block_owner.append(len(self._block_owner) % self.num_shards)
            self._block_nrows.append(int(rows))
        return super().push_rows(data, label=label, weight=weight)

    def shard_rows(self, rank: int) -> int:
        """Rows pushed into shard `rank` so far (a monotone watermark)."""
        with self._lock:
            return sum(n for o, n in zip(self._block_owner, self._block_nrows) if o == rank)

    def reshard(self, num_shards: int) -> None:
        """After the gang shrank: the pinned placements go round robin over
        the new shard count. The plane and the merged drift state do not
        depend on placement, so a resumed refit is the same bits."""
        with self._lock:
            self._num_shards = self._num_shards_req = max(1, int(num_shards))
            self._block_owner = [i % self._num_shards for i in range(len(self._block_owner))]
            if isinstance(self._drift, PodDriftMonitor):
                self._drift.reshard(self._num_shards)
        Log.info("streaming: re-sharded the block store over %d shards", self._num_shards)

    def follow_gang(self) -> None:
        """Reshard to the joined gang's size when it differs (a resumed
        refit after the gang shrank); alone, nothing changes."""
        world = _gang()
        if world is not None and world.size != self.num_shards:
            self.reshard(world.size)

    def _fit_and_drain(self) -> None:
        """The layout fit from merged exact sketches. Called under
        self._lock. Each shard folds its prefix blocks into one exact sketch
        a feature (k = 2 * bin_sample_rows: level 0 never compacts, so the
        sketch is the multiset) and the nonzero-position mask; an all-gather
        and the rank-ordered merge rebuild the global multiset, and the
        surrogate prefix goes through the stock fit."""
        n_prefix = min(self.bin_sample_rows, sum(b.shape[0] for b in self._raw_blocks))
        f = int(self.n_features)
        world = _gang()
        with global_timer.scope("stream_fit_layout"):
            if world is not None:
                payloads = _allgather_bytes(
                    self._shard_fit_payload(world.rank % self.num_shards, n_prefix, f))
            else:
                payloads = [self._shard_fit_payload(r, n_prefix, f)
                            for r in range(self.num_shards)]
            t0 = perf_counter()
            surrogate = self._merge_fit_payloads(payloads, n_prefix, f)
            global_timer.set_count("stream_sketch_merge_us", int((perf_counter() - t0) * 1e6))
            global_timer.add_count("stream_sketch_merges", 1)
            layout = CoreDataset(self.config)
            group_lists = layout._fit_layout(surrogate, self.categorical_feature)
            layout._make_groups(group_lists)
        self._layout = layout
        self._group_lists = group_lists
        if self._drift is not None:
            # the surrogate has the prefix's per-feature marginals, so the
            # occupancy baseline is the raw prefix's
            self._drift.set_reference(layout, surrogate)
        for blk in self._raw_blocks:
            self._bin_blocks.append(np.ascontiguousarray(layout._bin_rows(blk)))
        self._raw_blocks = []
        self._buffered = 0
        if telemetry.enabled():
            telemetry.emit("stream_layout_fitted", sample_rows=int(n_prefix),
                           num_groups=len(layout.groups), num_shards=self.num_shards)

    def _shard_fit_payload(self, rank: int, n_prefix: int, f: int) -> bytes:
        """Shard `rank`'s view of the prefix: exact sketches a feature over
        its rows, the (nonzero | NaN) mask and the rows' global offsets."""
        sketches = [QuantileSketch(max(8, 2 * n_prefix)) for _ in range(f)]
        seg_starts: List[int] = []
        seg_lens: List[int] = []
        masks: List[np.ndarray] = []
        row0 = 0
        for i, blk in enumerate(self._raw_blocks):
            take = min(blk.shape[0], n_prefix - row0)
            if take > 0 and self._block_owner[i] == rank:
                part = blk[:take]
                for j in range(f):
                    sketches[j].update(part[:, j])
                masks.append((part != 0) | np.isnan(part))
                seg_starts.append(row0)
                seg_lens.append(take)
            row0 += blk.shape[0]
            if row0 >= n_prefix:
                break
        arrays: Dict[str, np.ndarray] = {
            "rank": np.array([rank]),
            "seg_starts": np.asarray(seg_starts, dtype=np.int64),
            "seg_lens": np.asarray(seg_lens, dtype=np.int64),
            "mask": (np.concatenate(masks, axis=0) if masks else np.zeros((0, f), dtype=bool)),
        }
        for j in range(f):
            _sketch_to_arrays(sketches[j], f"sk{j}_", arrays)
        return _pack_arrays(arrays)

    @staticmethod
    def _merge_fit_payloads(payloads: List[bytes], n_prefix: int, f: int) -> np.ndarray:
        """The gathered shard payloads merged in rank order into the
        surrogate prefix `Dataset._fit_layout` takes."""
        shards = sorted((_unpack_arrays(p) for p in payloads), key=lambda a: int(a["rank"][0]))
        mask = np.zeros((n_prefix, f), dtype=bool)
        for arrays in shards:
            local0 = 0
            for start, length in zip(arrays["seg_starts"], arrays["seg_lens"]):
                mask[start:start + length] = arrays["mask"][local0:local0 + length]
                local0 += length
        surrogate = np.zeros((n_prefix, f), dtype=np.float64)
        for j in range(f):
            sk = merge_ranked([(int(a["rank"][0]), _sketch_from_arrays(f"sk{j}_", a))
                               for a in shards if a.get(f"sk{j}_meta") is not None])
            pos = np.flatnonzero(mask[:, j])
            vals, wts = sk.weighted()
            expanded = np.sort(np.repeat(vals, wts.astype(np.int64)))
            if len(expanded) != sk.nonzero_n:
                # a compacted sketch (the prefix outgrew k): a rank-uniform
                # resample, approximate as the reference's sampled fit
                expanded = np.sort(sk.quantile_sample(sk.nonzero_n))
            n_fill = min(len(expanded), len(pos))
            surrogate[pos[:n_fill], j] = expanded[:n_fill]
            if len(pos) > n_fill:  # the other masked rows were NaN
                surrogate[pos[n_fill:], j] = np.nan
        return surrogate


# -------------------------------------------------------- sharded learner

class ShardedStreamedTreeLearner(StreamedTreeLearner):
    """The streamed learner over a gang (see the module's notes). A world
    of one is the single-card streamed learner."""

    def __init__(self, config, dataset, device, world: Optional[World] = None,
                 budget_bytes: Optional[int] = None, block_rows: Optional[int] = None) -> None:
        self.world = world if world is not None else data_world(config.num_machines, device)
        self.num_shards = int(self.world.size)
        super().__init__(config, dataset, device, budget_bytes=budget_bytes,
                         block_rows=block_rows)

    def _make_cache(self, plane: np.ndarray, block_rows: int, capacity: int) -> _BlockCache:
        cache = _BlockCache(plane, block_rows, capacity, self.device,
                            shard=(self.world.rank, self.num_shards))
        global_timer.set_count("stream_shards", self.num_shards)
        return cache

    def _own_runs(self, rows: torch.Tensor):
        """This rank's runs of `rows` (block_runs), in order."""
        return [r for r in block_runs(rows, self._cache.block_rows)
                if r[0] % self.num_shards == self.world.rank]

    def _leaf_hist(self, leaf: int) -> torch.Tensor:
        if self.num_shards == 1:
            return super()._leaf_hist(leaf)
        cnt = self.partition.count(leaf)
        img = self._own_image(self.partition.indices(leaf)[:cnt])
        w = self.world
        before = global_timer.counters.get("collective_bytes", 0)
        sums = dist.all_reduce(w, img.sums)
        flags = img.flags
        # every rank holds the whole gh: the ranks agree whether flags cross
        if flags is not None and not bool(torch.isfinite(self._gh).all()):
            flags = decode_flags(dist.all_reduce(w, encode_flags(flags)))
        global_timer.add_count("stream_ici_bytes",
                               global_timer.counters.get("collective_bytes", 0) - before)
        G, B, CH = sums.shape
        wire = perfmodel.stream_ici_bytes_per_wave(G, B, CH, sums.element_size())
        global_timer.set_count("stream_ici_bytes_per_wave", wire)
        global_timer.set_count("device_ici_bytes_per_wave", wire)
        global_timer.add_count("stream_leaf_histograms", 1)
        return image_to_float(HistImage(sums, flags), self._exps)

    def _own_image(self, rows: torch.Tensor) -> HistImage:
        """The carried image of this rank's runs of `rows`, left open (the
        integer mode's int32 output; the CPU's float32 plain version)."""
        G, CH = len(self.dataset.groups), int(self._gh.shape[1])
        runs = self._own_runs(rows)
        if not runs:
            shape = (G, self.group_bin_padded, CH)
            dev = self.device
            if self.quantized or dev.type == "cpu":
                return HistImage(torch.zeros(shape, dtype=torch.int32 if self.quantized
                                             else torch.float32, device=dev))
            return HistImage(torch.zeros(shape, dtype=torch.int64, device=dev),
                             torch.zeros(shape, dtype=torch.int32, device=dev))
        cache = self._cache
        carry = HistogramCarry()
        img = None
        for i, (b, s, e) in enumerate(runs):
            bins_b = cache.get(b)
            if i + 1 < len(runs):
                cache.prefetch(runs[i + 1][0])
            lo, hi = cache.block_range(b)
            local = (rows[s:e] - lo).to(torch.int32)
            img = build_histogram_rows(bins_b, self._gh[lo:hi], local, self.group_bin_padded,
                                       count=e - s, exponents=self._exps, carry=carry,
                                       last=i + 1 == len(runs), image=True)
        return img

    def add_tree_to_score_blocked(self, tree, score: torch.Tensor, row_idx: torch.Tensor,
                                  max_depth: int = 0) -> torch.Tensor:
        """Each rank walks its own blocks' rows of `row_idx`; the per-row
        values are summed over the ranks (each row's from one rank) and
        added to each row's score once, as the single card adds them."""
        if self.num_shards == 1 or tree.num_leaves <= 1:
            return super().add_tree_to_score_blocked(tree, score, row_idx, max_depth)
        rows = row_idx[row_idx < self.num_data].to(torch.int64)
        vals = torch.zeros(self.num_data, dtype=score.dtype, device=score.device)
        ta = binned_tree_arrays(tree, self.dataset, self.device)
        bound = max_depth if max_depth > 0 else int(tree.max_depth)
        cache = self._cache
        runs = self._own_runs(rows)
        for i, (b, s, e) in enumerate(runs):
            bins_b = cache.get(b)
            if i + 1 < len(runs):
                cache.prefetch(runs[i + 1][0])
            lo, hi = cache.block_range(b)
            vals[rows[s:e]] = ta.leaf_value[binned_leaf_index(ta, bins_b, rows[s:e] - lo,
                                                              hi - lo, bound)]
        vals = dist.all_reduce(self.world, vals)
        return score.clone().index_add_(0, rows, vals[rows])
