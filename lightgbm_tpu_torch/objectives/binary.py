"""Binary classification objective.

Counterpart of BinaryLogloss (src/objective/binary_objective.hpp): sigmoid-
scaled logistic loss with is_unbalance / scale_pos_weight class weighting,
boost-from-average init score, and sigmoid output conversion.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import ObjectiveFunction, register_objective
from ..utils.log import Log

K_EPS = 1e-15


@register_objective("binary")
class BinaryLogloss(ObjectiveFunction):
    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            Log.fatal("Sigmoid parameter %f should be greater than zero", self.sigmoid)
        self.is_unbalance = config.is_unbalance
        self.scale_pos_weight = config.scale_pos_weight
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight at the same time")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label = metadata.label
        self.is_pos = (label > 0).astype(np.float64)
        cnt_pos = int(self.is_pos.sum())
        cnt_neg = num_data - cnt_pos
        self.need_train = True
        if cnt_pos == 0 or cnt_neg == 0:
            Log.warning("Contains only one class")
            self.need_train = False
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self.w_pos, self.w_neg = w_pos, w_neg
        # signed labels {-1, +1} and per-row class weights
        self._sign = torch.as_tensor(np.where(self.is_pos > 0, 1.0, -1.0),
                                     dtype=torch.float32, device=device)
        lw = np.where(self.is_pos > 0, w_pos, w_neg)
        if metadata.weights is not None:
            lw = lw * metadata.weights
        self._lw = torch.as_tensor(lw, dtype=torch.float32, device=device)

    def get_gradients(self, score):
        # response = -y*sigma / (1 + exp(y*sigma*score))  (binary_objective.hpp:117)
        response = -self._sign * self.sigmoid / (
            1.0 + torch.exp(self._sign * self.sigmoid * score))
        abs_r = torch.abs(response)
        grad = response * self._lw
        hess = abs_r * (self.sigmoid - abs_r) * self._lw
        return grad, hess

    def boost_from_score(self, class_id=0):
        if self.metadata.weights is not None:
            suml = float(np.sum(self.is_pos * self.metadata.weights))
            sumw = float(np.sum(self.metadata.weights))
        else:
            suml = float(self.is_pos.sum())
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, K_EPS), K_EPS), 1.0 - K_EPS)
        init = math.log(pavg / (1.0 - pavg)) / self.sigmoid
        Log.info("[binary:BoostFromScore]: pavg=%f -> initscore=%f", pavg, init)
        return init

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"binary sigmoid:{self.sigmoid:g}"
