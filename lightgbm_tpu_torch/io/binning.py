"""Per-feature quantile binning with reference-parity semantics.

Counterpart of BinMapper (include/LightGBM/bin.h:85-259, src/io/bin.cpp):
  * GreedyFindBin (bin.cpp:80-159): count-weighted greedy boundary placement
    over distinct values, big-count values get dedicated bins.
  * FindBinWithZeroAsOneBin (bin.cpp:246-291): zero gets its own
    [-1e-35, 1e-35] bin; negative/positive ranges binned separately.
  * FindBinWithPredefinedBin (bin.cpp:161-244): user-forced bin bounds.
  * BinMapper::FindBin (bin.cpp:315-513): missing handling (None/Zero/NaN),
    categorical count-ordered bin assignment with 99% mass cutoff,
    trivial-feature detection, most_freq_bin/default_bin bookkeeping.
  * ValueToBin (bin.h:612-650): searchsorted over upper bounds.

Binning runs on host (numpy) at dataset-construction time — it is a one-shot
O(#samples log #samples) preprocessing step; the resulting small per-feature
arrays ship to device as part of the binned matrix build.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common import (MISSING_NONE, MISSING_ZERO, MISSING_NAN,
                      K_ZERO_THRESHOLD, round_int)
from ..utils.log import Log

K_SPARSE_THRESHOLD = 0.8  # bin.h kSparseThreshold

BIN_TYPE_NUMERICAL = 0
BIN_TYPE_CATEGORICAL = 1


def _next_after_up(a: float) -> float:
    return math.nextafter(a, math.inf)


def _check_double_equal_ordered(a: float, b: float) -> bool:
    return b <= _next_after_up(a)


def greedy_find_bin(distinct_values: Sequence[float], counts: Sequence[int],
                    num_distinct_values: int, max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """bin.cpp:80-159 — returns upper bounds, last is +inf."""
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct_values <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct_values - 1):
            cur_cnt_inbin += counts[i]
            if cur_cnt_inbin >= min_data_in_bin:
                val = _next_after_up((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
    else:
        if min_data_in_bin > 0:
            max_bin = min(max_bin, total_cnt // min_data_in_bin)
            max_bin = max(max_bin, 1)
        mean_bin_size = total_cnt / max_bin
        rest_bin_cnt = max_bin
        rest_sample_cnt = total_cnt
        is_big = [counts[i] >= mean_bin_size for i in range(num_distinct_values)]
        for i in range(num_distinct_values):
            if is_big[i]:
                rest_bin_cnt -= 1
                rest_sample_cnt -= counts[i]
        mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt else math.inf
        upper_bounds = [math.inf] * max_bin
        lower_bounds = [math.inf] * max_bin
        bin_cnt = 0
        lower_bounds[0] = distinct_values[0]
        cur_cnt_inbin = 0
        for i in range(num_distinct_values - 1):
            if not is_big[i]:
                rest_sample_cnt -= counts[i]
            cur_cnt_inbin += counts[i]
            if (is_big[i] or cur_cnt_inbin >= mean_bin_size or
                    (is_big[i + 1] and cur_cnt_inbin >= max(1.0, mean_bin_size * 0.5))):
                upper_bounds[bin_cnt] = distinct_values[i]
                bin_cnt += 1
                lower_bounds[bin_cnt] = distinct_values[i + 1]
                if bin_cnt >= max_bin - 1:
                    break
                cur_cnt_inbin = 0
                if not is_big[i]:
                    rest_bin_cnt -= 1
                    mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt else math.inf
        bin_cnt += 1
        for i in range(bin_cnt - 1):
            val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
            if not bin_upper_bound or not _check_double_equal_ordered(bin_upper_bound[-1], val):
                bin_upper_bound.append(val)
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values: Sequence[float], counts: Sequence[int],
                                  num_distinct_values: int, max_bin: int,
                                  total_sample_cnt: int, min_data_in_bin: int) -> List[float]:
    """bin.cpp:246-291."""
    bin_upper_bound: List[float] = []
    left_cnt_data = cnt_zero = right_cnt_data = 0
    for i in range(num_distinct_values):
        if distinct_values[i] <= -K_ZERO_THRESHOLD:
            left_cnt_data += counts[i]
        elif distinct_values[i] > K_ZERO_THRESHOLD:
            right_cnt_data += counts[i]
        else:
            cnt_zero += counts[i]

    left_cnt = -1
    for i in range(num_distinct_values):
        if distinct_values[i] > -K_ZERO_THRESHOLD:
            left_cnt = i
            break
    if left_cnt < 0:
        left_cnt = num_distinct_values

    if left_cnt > 0 and max_bin > 1:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1)) if denom else 1
        left_max_bin = max(1, left_max_bin)
        bin_upper_bound = greedy_find_bin(distinct_values, counts, left_cnt,
                                          left_max_bin, left_cnt_data, min_data_in_bin)
        if bin_upper_bound:
            bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    right_start = -1
    for i in range(left_cnt, num_distinct_values):
        if distinct_values[i] > K_ZERO_THRESHOLD:
            right_start = i
            break

    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                                       num_distinct_values - right_start, right_max_bin,
                                       right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def find_bin_with_predefined_bin(distinct_values: Sequence[float], counts: Sequence[int],
                                 num_distinct_values: int, max_bin: int,
                                 total_sample_cnt: int, min_data_in_bin: int,
                                 forced_upper_bounds: Sequence[float]) -> List[float]:
    """bin.cpp:161-244 — forced bounds + zero bounds, greedy fill between."""
    bin_upper_bound: List[float] = []
    left_cnt = -1
    for i in range(num_distinct_values):
        if distinct_values[i] > -K_ZERO_THRESHOLD:
            left_cnt = i
            break
    if left_cnt < 0:
        left_cnt = num_distinct_values
    right_start = -1
    for i in range(left_cnt, num_distinct_values):
        if distinct_values[i] > K_ZERO_THRESHOLD:
            right_start = i
            break

    if max_bin == 2:
        bin_upper_bound.append(K_ZERO_THRESHOLD if left_cnt == 0 else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if left_cnt > 0:
            bin_upper_bound.append(-K_ZERO_THRESHOLD)
        if right_start >= 0:
            bin_upper_bound.append(K_ZERO_THRESHOLD)
    bin_upper_bound.append(math.inf)

    max_to_insert = max_bin - len(bin_upper_bound)
    num_inserted = 0
    for b in forced_upper_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(b) > K_ZERO_THRESHOLD:
            bin_upper_bound.append(b)
            num_inserted += 1
    bin_upper_bound.sort()

    free_bins = max_bin - len(bin_upper_bound)
    bounds_to_add: List[float] = []
    value_ind = 0
    n_fixed = len(bin_upper_bound)
    for i in range(n_fixed):
        cnt_in_bin = 0
        distinct_cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < num_distinct_values and distinct_values[value_ind] < bin_upper_bound[i]:
            cnt_in_bin += counts[value_ind]
            distinct_cnt_in_bin += 1
            value_ind += 1
        bins_remaining = max_bin - n_fixed - len(bounds_to_add)
        num_sub_bins = round_int(cnt_in_bin * free_bins / total_sample_cnt) if total_sample_cnt else 0
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == n_fixed - 1:
            num_sub_bins = bins_remaining + 1
        if distinct_cnt_in_bin > 0:
            new_bounds = greedy_find_bin(distinct_values[bin_start:], counts[bin_start:],
                                         distinct_cnt_in_bin, num_sub_bins, cnt_in_bin,
                                         min_data_in_bin)
            bounds_to_add.extend(new_bounds[:-1])  # last is inf
    bin_upper_bound.extend(bounds_to_add)
    bin_upper_bound.sort()
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


class BinMapper:
    """Maps raw feature values to bins and back."""

    def __init__(self) -> None:
        self.num_bin = 1
        self.missing_type = MISSING_NONE
        self.bin_type = BIN_TYPE_NUMERICAL
        self.is_trivial = True
        self.sparse_rate = 1.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.categorical_2_bin: Dict[int, int] = {}
        self.bin_2_categorical: List[int] = []
        self.min_val = 0.0
        self.max_val = 0.0
        self.default_bin = 0
        self.most_freq_bin = 0

    # ------------------------------------------------------------------ build

    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int = 3, min_split_data: int = 0,
                 pre_filter: bool = False, bin_type: int = BIN_TYPE_NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_upper_bounds: Sequence[float] = ()) -> None:
        """BinMapper::FindBin (bin.cpp:315-513) on a sampled value array.

        `values` holds the sampled non-zero values (zeros are implicit:
        total_sample_cnt - len(values) zeros), possibly with NaNs.
        """
        values = np.asarray(values, dtype=np.float64)
        num_sample_values = len(values)
        non_na = values[~np.isnan(values)]
        na_cnt = 0
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            if len(non_na) == num_sample_values:
                self.missing_type = MISSING_NONE
            else:
                self.missing_type = MISSING_NAN
                na_cnt = num_sample_values - len(non_na)
        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(non_na) - na_cnt)

        # distinct values with zero folded in at the right place
        sorted_vals = np.sort(non_na, kind="stable")
        distinct_values: List[float] = []
        counts: List[int] = []
        if len(sorted_vals) == 0 or (sorted_vals[0] > 0.0 and zero_cnt > 0):
            distinct_values.append(0.0)
            counts.append(zero_cnt)
        if len(sorted_vals) > 0:
            distinct_values.append(float(sorted_vals[0]))
            counts.append(1)
        for i in range(1, len(sorted_vals)):
            prev, cur = float(sorted_vals[i - 1]), float(sorted_vals[i])
            if not _check_double_equal_ordered(prev, cur):
                if prev < 0.0 and cur > 0.0:
                    distinct_values.append(0.0)
                    counts.append(zero_cnt)
                distinct_values.append(cur)
                counts.append(1)
            else:
                distinct_values[-1] = cur
                counts[-1] += 1
        if len(sorted_vals) > 0 and sorted_vals[-1] < 0.0 and zero_cnt > 0:
            distinct_values.append(0.0)
            counts.append(zero_cnt)

        self.min_val = distinct_values[0]
        self.max_val = distinct_values[-1]
        num_distinct_values = len(distinct_values)
        cnt_in_bin: List[int] = []

        if bin_type == BIN_TYPE_NUMERICAL:
            if self.missing_type == MISSING_NAN:
                bounds = find_bin_with_zero_as_one_bin(
                    distinct_values, counts, num_distinct_values, max_bin - 1,
                    total_sample_cnt - na_cnt, min_data_in_bin) if not forced_upper_bounds else \
                    find_bin_with_predefined_bin(distinct_values, counts, num_distinct_values,
                                                 max_bin - 1, total_sample_cnt - na_cnt,
                                                 min_data_in_bin, forced_upper_bounds)
                bounds = list(bounds) + [math.nan]
            else:
                bounds = find_bin_with_zero_as_one_bin(
                    distinct_values, counts, num_distinct_values, max_bin,
                    total_sample_cnt, min_data_in_bin) if not forced_upper_bounds else \
                    find_bin_with_predefined_bin(distinct_values, counts, num_distinct_values,
                                                 max_bin, total_sample_cnt,
                                                 min_data_in_bin, forced_upper_bounds)
                if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            self.bin_upper_bound = np.array(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            cnt_in_bin = [0] * self.num_bin
            i_bin = 0
            for i in range(num_distinct_values):
                while (i_bin < self.num_bin - 1 and
                       distinct_values[i] > self.bin_upper_bound[i_bin]):
                    i_bin += 1
                cnt_in_bin[i_bin] += counts[i]
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical (bin.cpp:416-481)
            dv_int: List[int] = []
            cnt_int: List[int] = []
            for v, c in zip(distinct_values, counts):
                iv = int(v)
                if iv < 0:
                    na_cnt += c
                    Log.warning("Met negative value in categorical features, will convert it to NaN")
                else:
                    if not dv_int or iv != dv_int[-1]:
                        dv_int.append(iv)
                        cnt_int.append(c)
                    else:
                        cnt_int[-1] += c
            rest_cnt = total_sample_cnt - na_cnt
            if rest_cnt > 0:
                # sort by counts descending (stable)
                order = sorted(range(len(dv_int)), key=lambda i: -cnt_int[i])
                dv_int = [dv_int[i] for i in order]
                cnt_int = [cnt_int[i] for i in order]
                cut_cnt = round_int((total_sample_cnt - na_cnt) * 0.99)
                distinct_cnt = len(dv_int) + (1 if na_cnt > 0 else 0)
                max_bin = min(distinct_cnt, max_bin)
                self.bin_2_categorical = [-1]
                self.categorical_2_bin = {-1: 0}
                cnt_in_bin = [0]
                self.num_bin = 1
                used_cnt = 0
                cur = 0
                while cur < len(dv_int) and (used_cnt < cut_cnt or self.num_bin < max_bin):
                    if cnt_int[cur] < min_data_in_bin and cur > 1:
                        break
                    self.bin_2_categorical.append(dv_int[cur])
                    self.categorical_2_bin[dv_int[cur]] = self.num_bin
                    used_cnt += cnt_int[cur]
                    cnt_in_bin.append(cnt_int[cur])
                    self.num_bin += 1
                    cur += 1
                if cur == len(dv_int) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                else:
                    self.missing_type = MISSING_NAN
                cnt_in_bin[0] = int(total_sample_cnt - used_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and self._need_filter(
                cnt_in_bin, int(total_sample_cnt), min_split_data):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = self.value_to_bin(0.0)
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
            if self.most_freq_bin != self.default_bin and max_sparse_rate < K_SPARSE_THRESHOLD:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    def _need_filter(self, cnt_in_bin: List[int], total_cnt: int, filter_cnt: int) -> bool:
        """bin.cpp NeedFilter: no split can satisfy min counts on either side."""
        if self.bin_type == BIN_TYPE_NUMERICAL:
            sum_left = 0
            for i in range(len(cnt_in_bin) - 1):
                sum_left += cnt_in_bin[i]
                if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                    return False
            return True
        else:
            if len(cnt_in_bin) <= 2:
                for i in range(len(cnt_in_bin)):
                    sum_left = cnt_in_bin[i]
                    if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                        return False
                return True
            return False

    # ------------------------------------------------------------------ query

    def value_to_bin(self, value: float) -> int:
        """bin.h:612-650."""
        if isinstance(value, str):
            value = float(value)
        if math.isnan(value):
            if self.bin_type == BIN_TYPE_CATEGORICAL:
                return 0
            if self.missing_type == MISSING_NAN:
                return self.num_bin - 1
            value = 0.0
        if self.bin_type == BIN_TYPE_NUMERICAL:
            ub = self.bin_upper_bound
            hi = self.num_bin - 1 if self.missing_type == MISSING_NAN else self.num_bin
            lo, r = 0, hi - 1
            while lo < r:
                mid = (lo + r) // 2
                if value <= ub[mid]:
                    r = mid
                else:
                    lo = mid + 1
            return lo
        iv = int(value)
        return self.categorical_2_bin.get(iv, 0)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin over a column."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_NUMERICAL:
            ub = self.bin_upper_bound
            n_search = self.num_bin - 1 if self.missing_type == MISSING_NAN else self.num_bin
            search_ub = ub[:n_search]
            vals = values.copy()
            nan_mask = np.isnan(vals)
            vals[nan_mask] = 0.0
            bins = np.searchsorted(search_ub, vals, side="left").astype(np.int32)
            bins = np.minimum(bins, n_search - 1)
            if self.missing_type == MISSING_NAN:
                bins[nan_mask] = self.num_bin - 1
            return bins
        # categorical: the bin of int(value), bin 0 for NaN and for a
        # category the mapper does not know
        if not self.categorical_2_bin:
            return np.zeros(len(values), dtype=np.int32)
        keys = np.array(sorted(self.categorical_2_bin), dtype=np.float64)
        bins_of = np.array([self.categorical_2_bin[int(k)] for k in keys], dtype=np.int32)
        iv = np.trunc(values)
        at = np.minimum(np.searchsorted(keys, iv), len(keys) - 1)
        known = ~np.isnan(iv) & (keys[at] == iv)
        return np.where(known, bins_of[at], 0).astype(np.int32)

    def bin_to_value(self, bin_idx: int) -> float:
        """Real threshold for a bin (BinMapper::BinToValue)."""
        if self.bin_type == BIN_TYPE_NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    def bin_info_string(self) -> str:
        """feature_infos entry (bin.h:224-233)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return ":".join(str(c) for c in self.bin_2_categorical)
        return f"[{self.min_val!r}:{self.max_val!r}]"

    # -------------------------------------------------------------- serialize

    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "bin_type": self.bin_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": self.bin_2_categorical,
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = d["num_bin"]
        m.missing_type = d["missing_type"]
        m.bin_type = d["bin_type"]
        m.is_trivial = d["is_trivial"]
        m.sparse_rate = d["sparse_rate"]
        m.bin_upper_bound = np.array(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = list(d["bin_2_categorical"])
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = d["min_val"]
        m.max_val = d["max_val"]
        m.default_bin = d["default_bin"]
        m.most_freq_bin = d["most_freq_bin"]
        return m
