"""Cross-entropy objectives for labels in [0, 1] (probabilities or
intensities).

Counterpart of the JAX package's ``objectives/xentropy.py``
(src/objective/xentropy_objective.hpp): CrossEntropy (alias xentropy,
:77-145) and CrossEntropyLambda (alias xentlambda, :223-268) with their
weighted parameterizations, boost-from-average inits (the label mean in
float64 on the host) and output conversions (sigmoid, log1p(exp)).
Elementwise PyTorch ops on the training device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import ObjectiveFunction, register_objective
from ..utils.log import Log

K_EPS = 1e-15


class _XentBase(ObjectiveFunction):
    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label = metadata.label.astype(np.float64)
        if np.any(label < 0):
            Log.fatal("[%s]: label should be non-negative", self.to_string())
        self.label = label
        self._label_dev = torch.as_tensor(label, dtype=torch.float32, device=device)
        self._w_dev = (torch.as_tensor(metadata.weights, device=device)
                       if metadata.weights is not None else None)

    def _avg_label(self) -> float:
        if self.metadata.weights is not None:
            suml = float(np.sum(self.label * self.metadata.weights))
            sumw = float(np.sum(self.metadata.weights))
        else:
            suml = float(self.label.sum())
            sumw = float(self.num_data)
        return suml / max(sumw, K_EPS)


@register_objective("cross_entropy", "xentropy")
class CrossEntropy(_XentBase):
    def get_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score))
        grad = z - self._label_dev
        hess = z * (1.0 - z)
        if self._w_dev is not None:
            grad = grad * self._w_dev
            hess = hess * self._w_dev
        return grad, hess

    def boost_from_score(self, class_id=0):
        pavg = min(max(self._avg_label(), K_EPS), 1.0 - K_EPS)
        init = math.log(pavg / (1.0 - pavg))
        Log.info("[cross_entropy:BoostFromScore]: pavg = %f -> initscore = %f", pavg, init)
        return init

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-raw))

    def to_string(self):
        return "cross_entropy"


@register_objective("cross_entropy_lambda", "xentlambda")
class CrossEntropyLambda(_XentBase):
    """Poisson-process parameterization: yhat = log1p(exp(score))
    (xentropy_objective.hpp:223-268)."""

    def get_gradients(self, score):
        if self._w_dev is None:
            z = 1.0 / (1.0 + torch.exp(-score))
            return z - self._label_dev, z * (1.0 - z)
        w = self._w_dev
        y = self._label_dev
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / torch.clamp(z, min=K_EPS)) * w / (1.0 + enf)
        c = 1.0 / torch.clamp(1.0 - z, min=K_EPS)
        d1 = 1.0 + epf
        a = w * epf / (d1 * d1)
        d = c - 1.0
        b = (c / torch.clamp(d * d, min=K_EPS)) * (1.0 + w * epf - c)
        return grad, a * (1.0 + y * b)

    def boost_from_score(self, class_id=0):
        havg = self._avg_label()
        init = math.log(max(math.expm1(havg), K_EPS))
        Log.info("[cross_entropy_lambda:BoostFromScore]: havg = %f -> initscore = %f",
                 havg, init)
        return init

    def convert_output(self, raw):
        return torch.log1p(torch.exp(raw))

    def to_string(self):
        return "cross_entropy_lambda"
