"""Regression-family objectives.

Counterpart of src/objective/regression_objective.hpp: l2, l1, huber, fair,
poisson, quantile, mape, gamma, tweedie. Gradients are elementwise torch
functions on the training device; percentile-style leaf refits
(RenewTreeOutput for l1/quantile/mape) run on the host over each leaf's
rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import ObjectiveFunction, register_objective
from ..utils.log import Log


def _weighted(grad, hess, w):
    if w is None:
        return grad, hess
    return grad * w, hess * w


def _percentile_refit(tree, score, labels, weights, partition, alpha_fn):
    """Recompute each leaf output as a (weighted) percentile of residuals —
    the RenewTreeOutput machinery for L1/quantile/MAPE objectives
    (regression_objective.hpp RenewTreeOutput; runs before shrinkage)."""
    score_np = score.cpu().numpy()
    for leaf in range(tree.num_leaves):
        cnt = partition.count(leaf)
        if cnt == 0:
            continue
        idx = partition.indices(leaf)[:cnt].cpu().numpy()
        resid = labels[idx] - score_np[idx]
        w = weights[idx] if weights is not None else None
        tree.set_leaf_output(leaf, float(alpha_fn(resid, w)))


def _weighted_percentile(values: np.ndarray, weights, alpha: float) -> float:
    """PercentileFun / WeightedPercentileFun (regression_objective.hpp:23-60)."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values)
    if weights is None:
        n = len(values)
        pos = alpha * n
        k = int(math.floor(pos))
        if k >= n:
            return float(values[order[-1]])
        if abs(pos - k) < 1e-12 and k > 0:
            return float(values[order[k - 1]] + values[order[k]]) / 2.0
        return float(values[order[k]])
    w = weights[order]
    cum = np.cumsum(w)
    target = alpha * cum[-1]
    k = int(np.searchsorted(cum, target))
    k = min(k, len(values) - 1)
    return float(values[order[k]])


@register_objective("regression", "regression_l2", "l2", "mean_squared_error", "mse")
class RegressionL2(ObjectiveFunction):
    is_constant_hessian = True

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.label = metadata.label.astype(np.float64)
        if self.sqrt:
            self.trans_label = np.sign(self.label) * np.sqrt(np.abs(self.label))
        else:
            self.trans_label = self.label
        self._label_dev = torch.as_tensor(self.trans_label, dtype=torch.float32,
                                          device=device)
        self._w_dev = (torch.as_tensor(metadata.weights, device=device)
                       if metadata.weights is not None else None)

    def get_gradients(self, score):
        grad = score - self._label_dev
        hess = torch.ones_like(score)
        return _weighted(grad, hess, self._w_dev)

    def boost_from_score(self, class_id=0):
        if self.metadata.weights is not None:
            suml = float(np.sum(self.trans_label * self.metadata.weights))
            sumw = float(np.sum(self.metadata.weights))
        else:
            suml = float(np.sum(self.trans_label))
            sumw = float(self.num_data)
        init = suml / sumw if sumw > 0 else 0.0
        Log.info("[regression:BoostFromScore]: pavg=%f -> initscore=%f", init, init)
        return init

    def convert_output(self, raw):
        if self.sqrt:
            return torch.sign(raw) * raw * raw
        return raw

    def to_string(self):
        return "regression"


@register_objective("regression_l1", "l1", "mean_absolute_error", "mae")
class RegressionL1(RegressionL2):
    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = torch.sign(diff)
        hess = torch.ones_like(score)
        return _weighted(grad, hess, self._w_dev)

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(self.label, self.metadata.weights, 0.5)

    def renew_tree_output(self, tree, score, partition):
        _percentile_refit(tree, score, self.label, self.metadata.weights, partition,
                          lambda r, w: _weighted_percentile(r, w, 0.5))

    def to_string(self):
        return "regression_l1"


@register_objective("huber")
class RegressionHuber(RegressionL2):
    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = config.alpha

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = torch.clamp(diff, -self.alpha, self.alpha)
        hess = torch.ones_like(score)
        return _weighted(grad, hess, self._w_dev)

    def to_string(self):
        return "huber"


@register_objective("fair")
class RegressionFair(RegressionL2):
    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.c = config.fair_c

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = self.c * diff / (torch.abs(diff) + self.c)
        hess = self.c * self.c / ((torch.abs(diff) + self.c) ** 2)
        return _weighted(grad, hess, self._w_dev)

    def to_string(self):
        return "fair"


@register_objective("poisson")
class RegressionPoisson(RegressionL2):
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.max_delta_step = config.poisson_max_delta_step

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.any(self.label < 0):
            Log.fatal("[poisson]: at least one target label is negative")

    def get_gradients(self, score):
        exp_s = torch.exp(score)
        grad = exp_s - self._label_dev
        hess = torch.exp(score + self.max_delta_step)
        return _weighted(grad, hess, self._w_dev)

    def boost_from_score(self, class_id=0):
        mean = super().boost_from_score(class_id)
        return math.log(max(mean, 1e-15))

    def convert_output(self, raw):
        return torch.exp(raw)

    def to_string(self):
        return "poisson"


@register_objective("quantile")
class RegressionQuantile(RegressionL2):
    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = config.alpha

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = torch.where(diff >= 0, 1.0 - self.alpha, -self.alpha).to(score.dtype)
        hess = torch.ones_like(score)
        return _weighted(grad, hess, self._w_dev)

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(self.label, self.metadata.weights, self.alpha)

    def renew_tree_output(self, tree, score, partition):
        _percentile_refit(tree, score, self.label, self.metadata.weights, partition,
                          lambda r, w: _weighted_percentile(r, w, self.alpha))

    def to_string(self):
        return "quantile"


@register_objective("mape", "mean_absolute_percentage_error")
class RegressionMAPE(RegressionL2):
    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.label_weight = 1.0 / np.maximum(1.0, np.abs(self.label))
        if metadata.weights is not None:
            self.label_weight = self.label_weight * metadata.weights
        self._lw_dev = torch.as_tensor(self.label_weight, dtype=torch.float32,
                                       device=device)

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = torch.sign(diff) * self._lw_dev
        hess = self._lw_dev.clone()
        return grad, hess

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(self.label, self.label_weight, 0.5)

    def renew_tree_output(self, tree, score, partition):
        _percentile_refit(tree, score, self.label, self.label_weight, partition,
                          lambda r, w: _weighted_percentile(r, w, 0.5))

    def to_string(self):
        return "mape"


@register_objective("gamma")
class RegressionGamma(RegressionPoisson):
    def get_gradients(self, score):
        exp_ns = torch.exp(-score)
        grad = 1.0 - self._label_dev * exp_ns
        hess = self._label_dev * exp_ns
        return _weighted(grad, hess, self._w_dev)

    def to_string(self):
        return "gamma"


@register_objective("tweedie")
class RegressionTweedie(RegressionPoisson):
    def __init__(self, config):
        super().__init__(config)
        self.rho = config.tweedie_variance_power

    def get_gradients(self, score):
        a = torch.exp((1.0 - self.rho) * score)
        b = torch.exp((2.0 - self.rho) * score)
        grad = -self._label_dev * a + b
        hess = (-self._label_dev * (1.0 - self.rho) * a
                + (2.0 - self.rho) * b)
        return _weighted(grad, hess, self._w_dev)

    def to_string(self):
        return "tweedie"
