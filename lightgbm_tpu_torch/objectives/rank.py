"""Learning-to-rank objectives: lambdarank and rank_xendcg.

Counterpart of the JAX package's ``objectives/rank.py``
(src/objective/rank_objective.hpp: LambdarankNDCG with |delta NDCG|-weighted
pairwise lambdas, truncation, sigmoid scaling, lambda normalization and
position debias; RankXENDCG, the listwise cross entropy of Bruch et al.
2019).

Queries are padded into dense [Q, L] blocks bucketed by length (powers of
two from 8; `QueryLayout`, built once on the host, its tensors on the
training device). A bucket's lambdas are tensor programs over its queries:
sort each query by score, build the [L, L] pairwise matrices, reduce the
rows and scatter back to the rows' order. The pairwise temporaries of a
bucket of long queries are large (16 MiB a matrix and a query at L = 2048),
so the queries go through in chunks sized to keep them under
`RANK_CHUNK_BYTES`. Every intermediate is float32, every expression in the
JAX package's order; the sums over a query run in PyTorch's order, and the
card's `exp` and `log2` are not the CPU's, so the gradients agree with the
JAX package's to a stated tolerance, not bit for bit.

Position debias keeps per-position bias factors, Newton-updated from each
iteration's lambdas; a position's gradient sums are exact in fixed point
(`ops/histogram.py:leaf_sums_fixed`, no order-dependent float atomic). The
objectives' state changes with every `get_gradients` call (xendcg's
iteration count, the position biases): `snapshot_state` and
`restore_snapshot_state` carry it through a checkpoint.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .registry import ObjectiveFunction, register_objective
from ..ops.histogram import leaf_sums_fixed
from ..ops.quantize import MASK32, threefry2x32
from ..utils.log import Log

K_MIN_SCORE = -1e30
# the [Qc, L, L] temporaries of one chunk of a bucket's queries stay under
# this many bytes (`_chunk_queries`)
RANK_CHUNK_BYTES = 1 << 30
PAIRWISE_TEMPS = 12  # float32 [L, L] matrices `lambdarank_lambdas` holds at once


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """DCGCalculator::DefaultLabelGain (dcg_calculator.cpp:33-42): 2^i - 1."""
    g = [0.0]
    for i in range(1, max_label):
        g.append(float((1 << i) - 1))
    return np.array(g)


def max_dcg_at_k(labels_sorted_desc: np.ndarray, k: int, gains: np.ndarray) -> float:
    """DCGCalculator::CalMaxDCGAtK, in float64 on the host."""
    n = min(len(labels_sorted_desc), k)
    disc = 1.0 / np.log2(np.arange(n) + 2.0)
    return float(np.sum(gains[labels_sorted_desc[:n].astype(int)] * disc))


class QueryLayout:
    """Queries padded into power-of-two length buckets, shared by the
    ranking objectives and metrics. Each bucket: L, its query ids (host),
    doc_idx [Qb, L] int64 (row ids, pad = num_data), labels [Qb, L]
    float32 (pad 0), valid [Qb, L] bool, and `slots`/`rows`, the flat
    positions of the valid slots and their rows (a scatter back to the
    rows' order with no host sync)."""

    def __init__(self, query_boundaries: np.ndarray, labels: np.ndarray, num_data: int,
                 device: torch.device, min_bucket: int = 8) -> None:
        self.num_data = num_data
        self.num_queries = len(query_boundaries) - 1
        bounds = np.asarray(query_boundaries, dtype=np.int64)
        lengths = np.diff(bounds)
        sizes = np.full(len(lengths), min_bucket, dtype=np.int64)
        while (sizes < lengths).any():
            sizes = np.where(sizes < lengths, sizes << 1, sizes)
        label_ext = np.append(np.asarray(labels, dtype=np.float32), np.float32(0))
        self.buckets: List[Dict] = []
        for L in np.unique(sizes):
            L = int(L)
            qids = np.flatnonzero(sizes == L)
            col = np.arange(L)[None, :]
            valid = col < lengths[qids][:, None]
            doc_idx = np.where(valid, bounds[qids][:, None] + col, num_data)
            slots = np.flatnonzero(valid.reshape(-1))
            self.buckets.append({
                "L": L,
                "qids": qids,
                "doc_idx": torch.from_numpy(doc_idx).to(device),
                "labels": torch.from_numpy(label_ext[doc_idx]).to(device),
                "valid": torch.from_numpy(valid).to(device),
                "slots": torch.from_numpy(slots).to(device),
                "rows": torch.from_numpy(doc_idx.reshape(-1)[slots]).to(device),
            })

    def scatter(self, parts, n: int, device: torch.device) -> torch.Tensor:
        """[n] float32 from one [Qb, L] tensor a bucket: each valid slot's
        value at its row."""
        out = torch.zeros(n, dtype=torch.float32, device=device)
        for b, part in zip(self.buckets, parts):
            out[b["rows"]] = part.reshape(-1)[b["slots"]]
        return out


def _chunk_queries(L: int, n_queries: int) -> int:
    """Queries of length bucket L a chunk may take so that its pairwise
    temporaries stay under RANK_CHUNK_BYTES."""
    return max(1, min(n_queries, RANK_CHUNK_BYTES // (PAIRWISE_TEMPS * 4 * L * L)))


def lambdarank_lambdas(s: torch.Tensor, lab: torch.Tensor, valid: torch.Tensor,
                       inv_max_dcg: torch.Tensor, gains: torch.Tensor, sigmoid: float,
                       truncation_level: int, norm: bool):
    """The lambdas and hessians [Q, L] of Q queries padded to L slots (the
    JAX package's rank.py:150-193, one query a row): scores s, labels,
    valid mask and 1/maxDCG@truncation [Q], all float32."""
    Q, L = s.shape
    dev = s.device
    s_pad = torch.where(valid, s, torch.tensor(K_MIN_SCORE, dtype=torch.float32, device=dev))
    # the JAX package sorts the negated key ascending, stably
    order = torch.argsort(-s_pad, dim=1, stable=True)
    ss = torch.gather(s_pad, 1, order)
    ls = torch.gather(lab, 1, order)
    vs = torch.gather(valid, 1, order)
    g = gains[ls.to(torch.int64)]
    pos = torch.arange(L, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    disc = torch.where(vs, 1.0 / torch.log2(pos.to(torch.float32) + 2.0), zero)
    best = ss[:, 0]
    cnt = vs.sum(dim=1)
    worst = torch.where(cnt > 0, torch.gather(ss, 1, (cnt - 1).clamp(min=0)[:, None])[:, 0],
                        zero)
    ds = ss[:, :, None] - ss[:, None, :]
    sign = torch.sign(ls[:, :, None] - ls[:, None, :])
    delta_hl = sign * ds
    delta_ndcg = (torch.abs(g[:, :, None] - g[:, None, :])
                  * torch.abs(disc[:, :, None] - disc[:, None, :])) * inv_max_dcg[:, None, None]
    if norm:
        ds.abs_().add_(0.01)
        delta_ndcg = torch.where((best != worst)[:, None, None], delta_ndcg / ds, delta_ndcg)
    del ds
    p = 1.0 / (1.0 + torch.exp(delta_hl * sigmoid))
    del delta_hl
    pair_ok = (vs[:, :, None] & vs[:, None, :] & (sign != 0)
               & (torch.minimum(pos[:, None], pos[None, :]) < truncation_level)[None]
               & (pos[:, None] != pos[None, :])[None])
    p_lambda = torch.where(pair_ok, -sigmoid * delta_ndcg * p, zero)
    p_hess = torch.where(pair_ok, sigmoid * sigmoid * delta_ndcg * p * (1.0 - p), zero)
    del p, delta_ndcg, pair_ok
    lam_sorted = torch.sum(sign * p_lambda, dim=2)
    hes_sorted = torch.sum(p_hess, dim=2)
    sum_lambdas = -torch.sum(p_lambda, dim=(1, 2))
    if norm:
        one = torch.ones((), dtype=torch.float32, device=dev)
        factor = torch.where(sum_lambdas > 0,
                             torch.log2(1.0 + sum_lambdas) / torch.clamp(sum_lambdas, min=1e-20),
                             one)
        lam_sorted = lam_sorted * factor[:, None]
        hes_sorted = hes_sorted * factor[:, None]
    lam = torch.zeros((Q, L), dtype=torch.float32, device=dev).scatter_(1, order, lam_sorted)
    hes = torch.zeros((Q, L), dtype=torch.float32, device=dev).scatter_(1, order, hes_sorted)
    return lam, hes


@register_objective("lambdarank")
class LambdarankNDCG(ObjectiveFunction):
    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            Log.fatal("Sigmoid param %f should be greater than zero", self.sigmoid)
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        self.label_gain = (np.array(config.label_gain, dtype=np.float64) if config.label_gain
                           else default_label_gain())

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            Log.fatal("Ranking tasks require query information")
        qb = metadata.query_boundaries
        label = metadata.label
        if label.max() >= len(self.label_gain):
            Log.fatal("Label %d is not less than the number of label mappings (%d)",
                      int(label.max()), len(self.label_gain))
        self.device = torch.device(device)
        self.layout = QueryLayout(qb, label, num_data, self.device)
        # per query 1/maxDCG@truncation, in float64 on the host, then float32
        inv = np.zeros(self.layout.num_queries)
        for q in range(self.layout.num_queries):
            srt = np.sort(label[qb[q]:qb[q + 1]])[::-1]
            mx = max_dcg_at_k(srt, self.truncation_level, self.label_gain)
            inv[q] = 1.0 / mx if mx > 0 else 0.0
        for b in self.layout.buckets:
            b["inv_max_dcg"] = torch.as_tensor(inv[b["qids"]], dtype=torch.float32,
                                               device=self.device)
        self._w = (torch.as_tensor(metadata.weights, device=self.device)
                   if metadata.weights is not None else None)
        self._gains = torch.as_tensor(self.label_gain, dtype=torch.float32, device=self.device)
        # position debias (rank_objective.hpp:43-90, 296-340)
        self._positions = None
        if metadata.positions is not None:
            self._positions = torch.as_tensor(metadata.positions, dtype=torch.int64,
                                              device=self.device)
            P = len(metadata.position_ids)
            self._num_positions = P
            self._pos_biases = torch.zeros(P, dtype=torch.float32, device=self.device)
            self._pos_counts = torch.bincount(self._positions, minlength=P).to(torch.float32)
            self._bias_reg = torch.tensor(
                self.config.lambdarank_position_bias_regularization, dtype=torch.float32,
                device=self.device)
            self._bias_lr = torch.tensor(self.config.learning_rate, dtype=torch.float32,
                                         device=self.device)

    def _bucket_lambdas(self, b: Dict, score_ext: torch.Tensor):
        s = score_ext[b["doc_idx"]]
        Qb, L = s.shape
        step = _chunk_queries(L, Qb)
        if step >= Qb:
            return lambdarank_lambdas(s, b["labels"], b["valid"], b["inv_max_dcg"],
                                      self._gains, self.sigmoid, self.truncation_level,
                                      self.norm)
        parts = [lambdarank_lambdas(s[i:i + step], b["labels"][i:i + step],
                                    b["valid"][i:i + step], b["inv_max_dcg"][i:i + step],
                                    self._gains, self.sigmoid, self.truncation_level, self.norm)
                 for i in range(0, Qb, step)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def _update_biases(self, grad: torch.Tensor, hess: torch.Tensor) -> None:
        """The JAX package's Newton step (rank.py:131-137), the gradient
        and hessian sums by position exact in fixed point."""
        sums = leaf_sums_fixed(torch.stack([grad, hess], dim=1), None, self._positions,
                               self._num_positions)
        fd = -sums[:, 0]
        sd = -sums[:, 1]
        b = self._pos_biases
        fd = fd - b * self._bias_reg * self._pos_counts
        sd = sd - self._bias_reg * self._pos_counts
        self._pos_biases = b + self._bias_lr * fd / (torch.abs(sd) + 0.001)

    def get_gradients(self, score):
        n = self.num_data
        if self._positions is not None:
            # lambdas from bias-adjusted scores; the model score is untouched
            score = score + self._pos_biases[self._positions]
        score_ext = torch.cat([score, torch.zeros(1, dtype=score.dtype, device=score.device)])
        lams, hess = zip(*(self._bucket_lambdas(b, score_ext) for b in self.layout.buckets))
        grad = self.layout.scatter(lams, n, score.device)
        hess = self.layout.scatter(hess, n, score.device)
        if self._w is not None:
            grad = grad * self._w
            hess = hess * self._w
        if self._positions is not None:
            self._update_biases(grad, hess)
        return grad, hess

    def snapshot_state(self) -> Dict[str, np.ndarray]:
        if self._positions is None:
            return {}
        return {"pos_biases": self._pos_biases.cpu().numpy()}

    def restore_snapshot_state(self, state: Dict) -> None:
        if self._positions is not None and "pos_biases" in state:
            self._pos_biases = torch.as_tensor(np.asarray(state["pos_biases"]),
                                               dtype=torch.float32, device=self.device)

    def to_string(self):
        return "lambdarank"


def xendcg_uniforms(seeds: np.ndarray, L: int, device) -> torch.Tensor:
    """[Q, L] float32: for each query's seed, ``jax.random.uniform(
    PRNGKey(seed), (L,), minval=1e-6, maxval=1.0)`` bit for bit. The
    threefry words at counters (0, i) of the key [0, seed] give u in [0, 1)
    (`ops/quantize.py`); JAX then takes max(minval, u * (maxval - minval) +
    minval) in float32, the multiply-add contracted into one rounding by
    XLA, as the float64 sum rounded once reproduces here (float64 holds the
    float32 product exactly)."""
    k1 = torch.as_tensor(np.asarray(seeds, dtype=np.int64) & MASK32, device=device)[:, None]
    i = torch.arange(L, dtype=torch.int64, device=device)[None, :]
    w0, w1 = threefry2x32(0, k1, i >> 32, i & MASK32)
    bits = ((w0 ^ w1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    minval = torch.tensor(1e-6, dtype=torch.float32, device=device)
    span = torch.tensor(1.0, dtype=torch.float32, device=device) - minval
    scaled = (u.to(torch.float64) * span.to(torch.float64) + minval.to(torch.float64))
    return torch.maximum(minval, scaled.to(torch.float32))


def xendcg_gradients(s: torch.Tensor, lab: torch.Tensor, valid: torch.Tensor,
                     uniforms: torch.Tensor):
    """The XE-NDCG lambdas and hessians [Q, L] (the JAX package's
    rank.py:260-273): softmax over the valid slots against the normalized
    Gumbel-perturbed gains."""
    dev = s.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    s_masked = torch.where(valid, s, torch.tensor(float("-inf"), dtype=torch.float32,
                                                  device=dev))
    gain = torch.where(valid, (torch.pow(2.0, lab) - 1.0) - torch.log(-torch.log(uniforms)),
                       zero)
    gain = torch.clamp(gain, min=0.0)
    # jax.nn.softmax: exp(x - max) over its sum
    e = torch.exp(s_masked - torch.amax(s_masked, dim=1, keepdim=True))
    rho = torch.where(valid, e / torch.sum(e, dim=1, keepdim=True), zero)
    gsum = torch.clamp(torch.sum(gain, dim=1, keepdim=True), min=1e-20)
    lam = rho - gain / gsum
    hes = torch.clamp(rho * (1.0 - rho), min=1e-16)
    return torch.where(valid, lam, zero), torch.where(valid, hes, zero)


@register_objective("rank_xendcg")
class RankXENDCG(ObjectiveFunction):
    """XE-NDCG (Bruch et al. 2019, 'An Alternative Cross Entropy Loss for
    Learning-to-Rank'): listwise softmax cross entropy against randomly
    perturbed relevance gains. Each call draws query q's uniforms from the
    seed (q * 9973 + iteration * 31 + objective_seed) mod 2**31, taken on
    the host in int64, the iteration counting the calls from 1."""

    def __init__(self, config):
        super().__init__(config)
        self.seed = config.objective_seed

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            Log.fatal("Ranking tasks require query information")
        self.layout = QueryLayout(metadata.query_boundaries, metadata.label, num_data,
                                  torch.device(device))
        self._w = (torch.as_tensor(metadata.weights, device=device)
                   if metadata.weights is not None else None)
        self._iter = 0

    def seeds(self, qids: np.ndarray) -> np.ndarray:
        """The draw's seed of each query at the current iteration."""
        return (qids.astype(np.int64) * 9973 + self._iter * 31 + self.seed) % (2 ** 31)

    def get_gradients(self, score):
        score_ext = torch.cat([score, torch.zeros(1, dtype=score.dtype, device=score.device)])
        self._iter += 1
        lams, hess = [], []
        for b in self.layout.buckets:
            u = xendcg_uniforms(self.seeds(b["qids"]), b["L"], score.device)
            lam, hes = xendcg_gradients(score_ext[b["doc_idx"]], b["labels"], b["valid"], u)
            lams.append(lam)
            hess.append(hes)
        grad = self.layout.scatter(lams, self.num_data, score.device)
        hess = self.layout.scatter(hess, self.num_data, score.device)
        if self._w is not None:
            grad = grad * self._w
            hess = hess * self._w
        return grad, hess

    def snapshot_state(self) -> Dict[str, int]:
        return {"iter": int(self._iter)}

    def restore_snapshot_state(self, state: Dict) -> None:
        self._iter = int(state.get("iter", self._iter))

    def to_string(self):
        return "rank_xendcg"
