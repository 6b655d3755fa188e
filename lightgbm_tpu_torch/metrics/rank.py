"""Ranking metrics: NDCG@k and MAP@k.

Counterpart of the JAX package's ``metrics/rank.py`` (src/metric/
rank_metric.hpp NDCGMetric: eval_at positions, the label-gain table, query
weights, a query with no relevant document counting 1; src/metric/
map_metric.hpp MapMetric). Queries use the ranking objectives' padded
bucket layout (`objectives/rank.py:QueryLayout`); a bucket's values for all
its queries are one stable sort by score, a gather and masked sums in
PyTorch ops on the evaluation device (NDCG's DCG in float32 as the JAX
package sums it, MAP in float64 as its host numpy does), and the
query-weighted mean is taken there in float64 with one host read.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import Metric, register_metric
from ..objectives.rank import QueryLayout, default_label_gain, max_dcg_at_k
from ..utils.log import Log


class _RankMetricBase(Metric):
    greater_is_better = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            Log.fatal("The NDCG metric requires query information")
        self.device = torch.device(device)
        self.layout = QueryLayout(metadata.query_boundaries, metadata.label, num_data,
                                  self.device)
        self.eval_at = [int(k) for k in (self.config.eval_at or [1, 2, 3, 4, 5])]
        qw = metadata.query_weights
        for b in self.layout.buckets:
            w = np.ones(len(b["qids"])) if qw is None else qw[b["qids"]]
            b["query_weight"] = torch.as_tensor(w, dtype=torch.float64, device=self.device)

    @property
    def name(self):
        return [f"{self.names[0]}@{k}" for k in self.eval_at]

    def _sorted(self, b, score_ext: torch.Tensor):
        """The bucket's labels and valid mask in descending score order
        (the negated score sorted ascending and stably, pads last)."""
        s = torch.where(b["valid"], score_ext[b["doc_idx"]],
                        torch.tensor(float("-inf"), dtype=score_ext.dtype,
                                     device=score_ext.device))
        order = torch.argsort(-s, dim=1, stable=True)
        return torch.gather(b["labels"], 1, order), torch.gather(b["valid"], 1, order)

    def _bucket_values(self, b, ls: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, score, objective):
        score_ext = torch.cat([score, torch.zeros(1, dtype=score.dtype, device=score.device)])
        totals = torch.zeros(len(self.eval_at), dtype=torch.float64, device=score.device)
        for b in self.layout.buckets:
            ls, vs = self._sorted(b, score_ext)
            vals = self._bucket_values(b, ls, vs).to(torch.float64)
            totals += (vals * b["query_weight"][:, None]).sum(dim=0)
        sumw = sum(float(b["query_weight"].sum()) for b in self.layout.buckets)
        return [float(t) / max(sumw, 1e-20) for t in totals.cpu().numpy()]


@register_metric("ndcg")
class NDCGMetric(_RankMetricBase):
    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        gains = (np.array(self.config.label_gain, dtype=np.float64) if self.config.label_gain
                 else default_label_gain())
        self._gains = torch.as_tensor(gains, dtype=torch.float32, device=self.device)
        qb = metadata.query_boundaries
        label = metadata.label
        # per (query, k): 1/maxDCG@k in float64, then float32; 0 marks a
        # query with no relevant document, whose NDCG is 1
        inv = np.zeros((self.layout.num_queries, len(self.eval_at)))
        for q in range(self.layout.num_queries):
            srt = np.sort(label[qb[q]:qb[q + 1]])[::-1]
            for j, k in enumerate(self.eval_at):
                mx = max_dcg_at_k(srt, k, gains)
                inv[q, j] = 1.0 / mx if mx > 0 else 0.0
        for b in self.layout.buckets:
            b["ndcg_inv"] = torch.as_tensor(inv[b["qids"]], dtype=torch.float32,
                                            device=self.device)

    def _bucket_values(self, b, ls, vs):
        L = ls.shape[1]
        dev = ls.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        g = torch.where(vs, self._gains[ls.to(torch.int64)], zero)
        pos = torch.arange(L, device=dev)
        disc = 1.0 / torch.log2(pos.to(torch.float32) + 2.0)
        out = []
        for j, k in enumerate(self.eval_at):
            dcg = torch.sum(g * disc * (pos < k), dim=1)
            inv = b["ndcg_inv"][:, j]
            out.append(torch.where(inv > 0, dcg * inv, torch.ones((), dtype=torch.float32,
                                                                   device=dev)))
        return torch.stack(out, dim=1)


@register_metric("map", "mean_average_precision")
class MapMetric(_RankMetricBase):
    """MAP@k per map_metric.hpp: labels > 0 are relevant; a query with no
    relevant document counts 1."""

    def _bucket_values(self, b, ls, vs):
        rel = ((ls > 0) & vs).to(torch.float64)
        cum_rel = torch.cumsum(rel, dim=1)
        prec = cum_rel / (torch.arange(rel.shape[1], dtype=torch.float64,
                                       device=rel.device) + 1.0)
        out = []
        for k in self.eval_at:
            ap_num = (prec[:, :k] * rel[:, :k]).sum(dim=1)
            denom = torch.clamp(cum_rel[:, -1], max=float(k))
            out.append(torch.where(denom > 0, ap_num / torch.clamp(denom, min=1.0),
                                   torch.ones_like(ap_num)))
        return torch.stack(out, dim=1)
