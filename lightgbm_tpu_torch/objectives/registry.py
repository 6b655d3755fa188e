"""Objective function interface + factory.

Counterpart of ObjectiveFunction (include/LightGBM/objective_function.h:19-90)
and its factory (src/objective/objective_function.cpp:71-119). Objectives are
per-row gradient/hessian producers: elementwise torch functions over the
score and label tensors on the training device. Every objective converts
output for a loaded model; the binary, regression and multiclass families
also train (`init`, `get_gradients`, `boost_from_score`). The others carry
``trainable = False`` and training with one is refused.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

import torch

from ..config import Config
from ..io.metadata import Metadata
from ..utils.log import Log

OBJECTIVE_REGISTRY: Dict[str, Type] = {}

# objectives the JAX package trains whose port is not written yet: a model
# naming one loads (raw scores need no objective) but converted output fails
NOT_YET_PORTED = ("lambdarank", "rank_xendcg", "cross_entropy", "xentropy",
                  "cross_entropy_lambda", "xentlambda")


def register_objective(*names: str):
    def deco(cls):
        for n in names:
            OBJECTIVE_REGISTRY[n] = cls
        cls.names = names
        return cls

    return deco


class ObjectiveFunction:
    """Base interface (objective_function.h:29-90)."""

    is_constant_hessian = False
    # whether this objective's gradients are ported (binary, regression,
    # multiclass)
    trainable = False

    def __init__(self, config: Config) -> None:
        self.config = config
        self.metadata: Optional[Metadata] = None
        self.num_data = 0

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        """Bind the training labels; per-row tensors go to `device`."""
        self.metadata = metadata
        self.num_data = num_data

    def get_gradients(self, score):
        """score [N] (or [C, N]) -> (grad, hess) of the same shape."""
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        """Initial raw score (BoostFromScore, objective_function.h:65)."""
        return 0.0

    def convert_output(self, raw):
        """Raw score tensor [N, C] -> output space (sigmoid/exp/identity)."""
        return raw

    def renew_tree_output(self, tree, score, partition) -> None:
        """Leaf-value refitting hook (RenewTreeOutput) for percentile-style
        objectives (L1/quantile/MAPE); default no-op."""
        return None

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    @property
    def num_class(self) -> int:
        return 1

    def to_string(self) -> str:
        return self.names[0]


class NotYetPorted(ObjectiveFunction):
    """Stand-in for an objective whose port is a later slice: raw scores
    predict as usual, converted output raises instead of returning raw
    scores under the converted name."""

    def __init__(self, config: Config, name: str) -> None:
        super().__init__(config)
        self.name = name

    def convert_output(self, raw):
        Log.fatal("objective %s is not yet ported: its output conversion is "
                  "missing; predict with raw_score=True", self.name)

    def to_string(self) -> str:
        return self.name


def create_objective(name: str, config: Config) -> Optional[ObjectiveFunction]:
    from . import regression, binary, multiclass  # noqa: F401

    if name in ("custom", "none", "null", "na") or not name:
        return None
    if name in NOT_YET_PORTED:
        return NotYetPorted(config, name)
    cls = OBJECTIVE_REGISTRY.get(name)
    if cls is None:
        Log.fatal("Unknown objective type name: %s", name)
    return cls(config)
