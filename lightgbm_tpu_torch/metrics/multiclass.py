"""Multiclass metrics: counterpart of the JAX package's
``metrics/multiclass.py`` (src/metric/multiclass_metric.hpp): multi_logloss,
multi_error (with multi_error_top_k) and auc_mu. The first two evaluate on
the training device; auc_mu sorts each class pair on the host in float64,
as the JAX package does (the pair's margins in float32, the sums in
float64)."""
from __future__ import annotations

import numpy as np
import torch

from .registry import Metric, register_metric


class _MulticlassBase(Metric):
    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._label = torch.as_tensor(metadata.label.astype(np.int64), device=device)
        self._w = (torch.as_tensor(metadata.weights, device=device)
                   if metadata.weights is not None else None)
        self._sumw = (float(np.sum(metadata.weights)) if metadata.weights is not None
                      else float(num_data))

    def _probs(self, score, objective):
        # score [C, N] -> probabilities [N, C]
        if objective is not None:
            return objective.convert_output(score.T)
        return torch.softmax(score.T, dim=-1)

    def _true_prob(self, p):
        return p.gather(1, self._label[:, None])[:, 0]


@register_metric("multi_logloss", "multiclass", "softmax")
class MultiLoglossMetric(_MulticlassBase):
    def eval(self, score, objective):
        p = self._probs(score, objective)
        eps = 1e-15
        loss = -torch.log(torch.clamp(self._true_prob(p), eps, 1.0))
        if self._w is not None:
            loss = loss * self._w
        return [float(torch.sum(loss)) / self._sumw]


@register_metric("multi_error")
class MultiErrorMetric(_MulticlassBase):
    def eval(self, score, objective):
        p = self._probs(score, objective)
        top_k = max(self.config.multi_error_top_k, 1)
        # correct when fewer than top_k classes score strictly above the
        # true one: ties count as correct (MultiErrorMetric's
        # PointWiseLossCalculator)
        rank = torch.sum(p > self._true_prob(p)[:, None], dim=1)
        err = 1.0 - (rank < top_k).to(torch.float32)
        if self._w is not None:
            err = err * self._w
        return [float(torch.sum(err)) / self._sumw]


@register_metric("auc_mu")
class AucMuMetric(_MulticlassBase):
    greater_is_better = True

    def eval(self, score, objective):
        """AUC-mu (Kleiman & Page 2019): the mean pairwise class
        separability (multiclass_metric.hpp auc_mu), each pair weighted by
        auc_mu_weights when given, else 1."""
        p = self._probs(score, objective).cpu().numpy()  # float32, as the JAX package's
        label = self._label.cpu().numpy()
        w = self._w.cpu().numpy() if self._w is not None else np.ones(len(label))
        C = p.shape[1]
        W = np.ones((C, C))
        if self.config.auc_mu_weights:
            W = np.asarray(self.config.auc_mu_weights, dtype=np.float64).reshape(C, C)
        total = 0.0
        count = 0
        for a in range(C):
            for b in range(a + 1, C):
                ia = label == a
                ib = label == b
                if not ia.any() or not ib.any():
                    continue
                va = p[ia, a] - p[ia, b]
                vb = p[ib, a] - p[ib, b]
                wa, wb = w[ia], w[ib]
                order = np.argsort(np.concatenate([va, vb]), kind="stable")
                y = np.concatenate([np.ones(len(va)), np.zeros(len(vb))])[order]
                ww = np.concatenate([wa, wb])[order]
                cum_neg = np.cumsum(ww * (1 - y))
                auc_num = float(np.sum(ww * y * cum_neg))
                denom = float(np.sum(wa) * np.sum(wb))
                if denom > 0:
                    total += W[a, b] * auc_num / denom
                    count += 1
        return [total / max(count, 1)]
