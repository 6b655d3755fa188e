"""Regression metrics — counterpart of src/metric/regression_metric.hpp."""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import Metric, register_metric


class _PointwiseRegression(Metric):
    """Weighted mean of a pointwise loss over converted outputs."""

    convert = True  # apply objective.convert_output first

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._label = torch.as_tensor(metadata.label, dtype=torch.float32,
                                      device=device)
        self._w = (torch.as_tensor(metadata.weights, device=device)
                   if metadata.weights is not None else None)
        self._sumw = (float(np.sum(metadata.weights))
                      if metadata.weights is not None else float(num_data))

    def point_loss(self, pred, label):
        raise NotImplementedError

    def transform(self, avg):
        return avg

    def _pred(self, score, objective):
        if self.convert and objective is not None:
            return objective.convert_output(score)
        return score

    def _losses(self, score, objective):
        losses = self.point_loss(self._pred(score, objective), self._label)
        return losses * self._w if self._w is not None else losses

    def eval(self, score, objective):
        return [self.transform(
            float(torch.sum(self._losses(score, objective))) / self._sumw)]


@register_metric("l2", "mean_squared_error", "mse", "regression", "regression_l2")
class L2Metric(_PointwiseRegression):
    def point_loss(self, pred, label):
        return (pred - label) ** 2


@register_metric("rmse", "root_mean_squared_error", "l2_root")
class RMSEMetric(L2Metric):
    def transform(self, avg):
        return math.sqrt(avg)


@register_metric("l1", "mean_absolute_error", "mae", "regression_l1")
class L1Metric(_PointwiseRegression):
    def point_loss(self, pred, label):
        return torch.abs(pred - label)


@register_metric("quantile")
class QuantileMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        alpha = self.config.alpha
        delta = label - pred
        return torch.where(delta < 0, (alpha - 1.0) * delta, alpha * delta)


@register_metric("huber")
class HuberMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        alpha = self.config.alpha
        diff = torch.abs(pred - label)
        return torch.where(diff <= alpha, 0.5 * diff * diff,
                           alpha * (diff - 0.5 * alpha))


@register_metric("fair")
class FairMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        c = self.config.fair_c
        x = torch.abs(pred - label)
        return c * x - c * c * torch.log1p(x / c)


@register_metric("poisson")
class PoissonMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        pred = torch.clamp(pred, min=1e-10)
        return pred - label * torch.log(pred)


@register_metric("mape", "mean_absolute_percentage_error")
class MAPEMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        return torch.abs((label - pred) / torch.clamp(torch.abs(label), min=1.0))


@register_metric("gamma")
class GammaMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        psi = 1.0
        theta = -1.0 / torch.clamp(pred, min=1e-10)
        a = psi
        b = -torch.log(-theta)
        c = 1.0 / psi * torch.log(label / psi) - torch.log(label) - 0.0
        return -((label * theta - b) / a + c)


@register_metric("gamma_deviance")
class GammaDevianceMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        epsilon = 1e-9
        tmp = label / (pred + epsilon)
        return tmp - torch.log(tmp) - 1.0

    def eval(self, score, objective):
        # the deviance is twice the sum, not a weighted mean
        return [float(torch.sum(self._losses(score, objective))) * 2.0]


@register_metric("tweedie")
class TweedieMetric(_PointwiseRegression):
    def point_loss(self, pred, label):
        rho = self.config.tweedie_variance_power
        pred = torch.clamp(pred, min=1e-10)
        a = label * torch.exp((1.0 - rho) * torch.log(pred)) / (1.0 - rho)
        b = torch.exp((2.0 - rho) * torch.log(pred)) / (2.0 - rho)
        return -a + b


@register_metric("r2")
class R2Metric(_PointwiseRegression):
    greater_is_better = True

    def eval(self, score, objective):
        pred = self._pred(score, objective)
        label = self._label
        w = self._w if self._w is not None else torch.ones_like(label)
        mean = torch.sum(label * w) / torch.sum(w)
        ss_res = torch.sum(w * (label - pred) ** 2)
        ss_tot = torch.sum(w * (label - mean) ** 2)
        return [float(1.0 - ss_res / torch.clamp(ss_tot, min=1e-30))]
