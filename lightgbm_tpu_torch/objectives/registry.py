"""Objective function interface + factory.

Counterpart of ObjectiveFunction (include/LightGBM/objective_function.h:19-90)
and its factory (src/objective/objective_function.cpp:71-119). Objectives are
per-row gradient/hessian producers: torch functions over the score and
label tensors on the training device (binary, regression, multiclass,
cross entropy, and the ranking objectives over padded query blocks).
Objectives whose state changes with every `get_gradients` call (the ranking
ones) expose it through `snapshot_state` / `restore_snapshot_state`, which
a checkpoint carries.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Type

import torch

from ..config import Config
from ..io.metadata import Metadata
from ..utils.log import Log

OBJECTIVE_REGISTRY: Dict[str, Type] = {}


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

    def snapshot_state(self) -> Dict[str, Any]:
        """The state that earlier `get_gradients` calls left (none for an
        elementwise objective), for a checkpoint's sidecar."""
        return {}

    def restore_snapshot_state(self, state: Dict[str, Any]) -> None:
        """Put back what `snapshot_state` returned."""

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    @property
    def num_class(self) -> int:
        return 1

    def to_string(self) -> str:
        return self.names[0]


def create_objective(name: str, config: Config) -> Optional[ObjectiveFunction]:
    from . import regression, binary, multiclass, rank, xentropy  # noqa: F401

    if name in ("custom", "none", "null", "na") or not name:
        return None
    cls = OBJECTIVE_REGISTRY.get(name)
    if cls is None:
        Log.fatal("Unknown objective type name: %s", name)
    return cls(config)
