"""Binary metrics — counterpart of src/metric/binary_metric.hpp: logloss,
error rate, AUC, average precision. AUC and average precision sort the
scores on the device and accumulate weighted ranks (binary_metric.hpp
AUCMetric::Eval's sorted scan)."""
from __future__ import annotations

import numpy as np
import torch

from .registry import Metric, register_metric


@register_metric("binary_logloss", "binary")
class BinaryLoglossMetric(Metric):
    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._is_pos = torch.as_tensor((metadata.label > 0), dtype=torch.float32,
                                       device=device)
        self._w = (torch.as_tensor(metadata.weights, device=device)
                   if metadata.weights is not None else None)
        self._sumw = (float(np.sum(metadata.weights))
                      if metadata.weights is not None else float(num_data))

    def eval(self, score, objective):
        prob = objective.convert_output(score) if objective is not None else score
        eps = 1e-15
        prob = torch.clamp(prob, eps, 1.0 - eps)
        loss = -(self._is_pos * torch.log(prob)
                 + (1.0 - self._is_pos) * torch.log(1.0 - prob))
        if self._w is not None:
            loss = loss * self._w
        return [float(torch.sum(loss)) / self._sumw]


@register_metric("binary_error")
class BinaryErrorMetric(BinaryLoglossMetric):
    def eval(self, score, objective):
        prob = objective.convert_output(score) if objective is not None else score
        pred_pos = prob > 0.5
        err = (pred_pos.to(torch.float32) != self._is_pos).to(torch.float32)
        if self._w is not None:
            err = err * self._w
        return [float(torch.sum(err)) / self._sumw]


def _auc(score, is_pos, weights):
    """Weighted AUC via ranks: for each positive, the weight of negatives
    scored below it, ties getting half credit. The prefix sums run in
    float64: a tie group's negative mass is a difference of two prefixes,
    so no scatter (and no atomic order) enters the value."""
    order = torch.argsort(score, stable=True)
    s = score[order]
    y = is_pos[order].double()
    w = weights[order].double() if weights is not None else torch.ones_like(y)
    wneg = w * (1.0 - y)
    wpos = w * y
    cum_neg = torch.cumsum(wneg, 0)
    n = s.shape[0]
    is_new = torch.ones(n, dtype=torch.bool, device=s.device)
    is_new[1:] = s[1:] > s[:-1]
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
    starts = torch.nonzero(is_new).reshape(-1)
    ends = torch.cat([starts[1:] - 1,
                      torch.tensor([n - 1], dtype=starts.dtype, device=s.device)])
    before = cum_neg[starts] - wneg[starts]  # negatives below the tie group
    in_seg = cum_neg[ends] - before
    credit = before[seg] + 0.5 * in_seg[seg]
    total_pos = torch.sum(wpos)
    total_neg = torch.sum(wneg)
    return torch.sum(wpos * credit) / torch.clamp(total_pos * total_neg, min=1e-30)


@register_metric("auc")
class AUCMetric(Metric):
    greater_is_better = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._is_pos = torch.as_tensor((metadata.label > 0), dtype=torch.float32,
                                       device=device)
        self._w = (torch.as_tensor(metadata.weights, device=device)
                   if metadata.weights is not None else None)

    def eval(self, score, objective):
        return [float(_auc(score, self._is_pos, self._w))]


@register_metric("average_precision")
class AveragePrecisionMetric(AUCMetric):
    def eval(self, score, objective):
        order = torch.argsort(-score, stable=True)
        y = self._is_pos[order]
        w = self._w[order] if self._w is not None else torch.ones_like(y)
        wpos = w * y
        cum_pos = torch.cumsum(wpos, 0)
        cum_all = torch.cumsum(w, 0)
        precision = cum_pos / torch.clamp(cum_all, min=1e-30)
        total_pos = torch.clamp(torch.sum(wpos), min=1e-30)
        return [float(torch.sum(precision * wpos) / total_pos)]
