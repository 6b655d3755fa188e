"""Cross-entropy metrics — counterpart of the JAX package's
``metrics/xentropy.py`` (src/metric/xentropy_metric.hpp): cross_entropy,
cross_entropy_lambda, kullback_leibler, as PyTorch ops on the evaluation
device."""
from __future__ import annotations

import numpy as np
import torch

from .registry import Metric, register_metric

K_EPS = 1e-12


def _xent(label: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(prob, K_EPS, 1.0 - K_EPS)
    return -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))


def _sigmoid_or_objective(score, objective):
    return (objective.convert_output(score) if objective is not None
            else 1.0 / (1.0 + torch.exp(-score)))


class _XentMetricBase(Metric):
    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._label = torch.as_tensor(metadata.label, dtype=torch.float32, device=device)
        self._w = (torch.as_tensor(metadata.weights, device=device)
                   if metadata.weights is not None else None)
        self._sumw = (float(np.sum(metadata.weights)) if metadata.weights is not None
                      else float(num_data))

    def _mean(self, loss: torch.Tensor) -> float:
        if self._w is not None:
            loss = loss * self._w
        return float(torch.sum(loss)) / self._sumw


@register_metric("cross_entropy", "xentropy")
class CrossEntropyMetric(_XentMetricBase):
    def eval(self, score, objective):
        return [self._mean(_xent(self._label, _sigmoid_or_objective(score, objective)))]


@register_metric("cross_entropy_lambda", "xentlambda")
class CrossEntropyLambdaMetric(_XentMetricBase):
    def eval(self, score, objective):
        # z = 1 - exp(-w * log1p(exp(score))): the weights enter z, not the sum
        hhat = torch.log1p(torch.exp(score))
        w = self._w if self._w is not None else 1.0
        z = torch.clamp(1.0 - torch.exp(-w * hhat), K_EPS, 1.0 - K_EPS)
        loss = -(self._label * torch.log(z) + (1.0 - self._label) * torch.log(1.0 - z))
        return [float(torch.sum(loss)) / self._sumw]


@register_metric("kullback_leibler", "kldiv")
class KullbackLeiblerMetric(_XentMetricBase):
    def eval(self, score, objective):
        prob = _sigmoid_or_objective(score, objective)
        y = torch.clamp(self._label, K_EPS, 1.0 - K_EPS)
        # KL(y || p) = xent(y, p) - entropy(y)
        ent = -(y * torch.log(y) + (1.0 - y) * torch.log(1.0 - y))
        return [self._mean(_xent(self._label, prob) - ent)]
