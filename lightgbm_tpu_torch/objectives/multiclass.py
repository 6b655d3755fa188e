"""Multiclass objectives: softmax and one-vs-all.

Counterpart of the JAX package's ``objectives/multiclass.py``
(src/objective/multiclass_objective.hpp): MulticlassSoftmax (grad = p - y,
hess = K/(K-1) * p * (1-p), :86-107, 31) and MulticlassOVA (a BinaryLogloss
for each class, :228-268). num_class trees per iteration; scores are [C, N]
on the training device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .binary import BinaryLogloss
from .registry import ObjectiveFunction, register_objective
from ..io.metadata import Metadata
from ..utils.log import Log

K_EPS = 1e-15


@register_objective("multiclass", "softmax")
class MulticlassSoftmax(ObjectiveFunction):
    def __init__(self, config):
        super().__init__(config)
        self.num_class_ = config.num_class
        if self.num_class_ < 2:
            Log.fatal("Number of classes should be specified and greater than 1 for multiclass training")
        self.factor = self.num_class_ / (self.num_class_ - 1.0)

    @property
    def num_model_per_iteration(self):
        return self.num_class_

    @property
    def num_class(self):
        return self.num_class_

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label_int = metadata.label.astype(np.int32)
        if label_int.min() < 0 or label_int.max() >= self.num_class_:
            Log.fatal("Label must be in [0, %d), but found %d in label",
                      self.num_class_, int(label_int.max()))
        onehot = np.zeros((self.num_class_, num_data), dtype=np.float32)
        onehot[label_int, np.arange(num_data)] = 1.0
        self._onehot = torch.as_tensor(onehot, device=device)
        self._w = (torch.as_tensor(metadata.weights, device=device)
                   if metadata.weights is not None else None)
        probs = onehot.sum(axis=1) if metadata.weights is None else \
            (onehot * np.asarray(metadata.weights)[None, :]).sum(axis=1)
        self.class_init_probs = probs / probs.sum()

    def get_gradients(self, score):
        """score [C, N] -> (grad [C, N], hess [C, N]): softmax over classes."""
        p = torch.softmax(score, dim=0)
        grad = p - self._onehot
        hess = self.factor * p * (1.0 - p)
        if self._w is not None:
            grad = grad * self._w[None, :]
            hess = hess * self._w[None, :]
        return grad, hess

    def boost_from_score(self, class_id=0):
        init = math.log(max(K_EPS, float(self.class_init_probs[class_id])))
        Log.info("[multiclass:BoostFromScore]: class %d init=%f", class_id, init)
        return init

    def class_need_train(self, class_id):
        p = float(self.class_init_probs[class_id])
        return K_EPS < abs(p) < 1.0 - K_EPS

    def convert_output(self, raw):
        """Softmax over the class axis; raw is [N, C]."""
        return torch.softmax(raw, dim=-1)

    def to_string(self):
        return f"multiclass num_class:{self.num_class_}"


@register_objective("multiclassova", "multiclass_ova", "ova", "ovr")
class MulticlassOVA(ObjectiveFunction):
    def __init__(self, config):
        super().__init__(config)
        self.num_class_ = config.num_class
        if self.num_class_ < 2:
            Log.fatal("Number of classes should be specified and greater than 1 for multiclass training")
        self.sigmoid = config.sigmoid
        self._binaries = [BinaryLogloss(config) for _ in range(self.num_class_)]

    @property
    def num_model_per_iteration(self):
        return self.num_class_

    @property
    def num_class(self):
        return self.num_class_

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label = metadata.label
        for k, b in enumerate(self._binaries):
            md = Metadata(num_data)
            md.label = (label.astype(np.int32) == k).astype(np.float32)
            md.weights = metadata.weights
            b.init(md, num_data, device)

    def get_gradients(self, score):
        grads, hesses = [], []
        for k, b in enumerate(self._binaries):
            g, h = b.get_gradients(score[k])
            grads.append(g)
            hesses.append(h)
        return torch.stack(grads), torch.stack(hesses)

    def boost_from_score(self, class_id=0):
        return self._binaries[class_id].boost_from_score(0)

    def class_need_train(self, class_id):
        return self._binaries[class_id].need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"multiclassova num_class:{self.num_class_} sigmoid:{self.sigmoid:g}"
