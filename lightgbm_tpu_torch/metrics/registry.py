"""Metric interface + factory.

Counterpart of Metric (include/LightGBM/metric.h:24-60) and its factory
(src/metric/metric.cpp:21-120). Metrics evaluate score tensors on the
training device; the objective's ConvertOutput is applied where the
reference does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Type

import torch

from ..config import Config
from ..io.metadata import Metadata
from ..utils.log import Log

METRIC_REGISTRY: Dict[str, Type] = {}


def register_metric(*names: str):
    def deco(cls):
        for n in names:
            METRIC_REGISTRY[n] = cls
        cls.names = names
        return cls

    return deco


class Metric:
    """Base: Init + Eval(score, objective) -> list of values."""

    greater_is_better = False

    def __init__(self, config: Config) -> None:
        self.config = config
        self.metadata: Optional[Metadata] = None
        self.num_data = 0

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        self.metadata = metadata
        self.num_data = num_data

    def eval(self, score, objective) -> List[float]:
        raise NotImplementedError

    @property
    def name(self) -> List[str]:
        return [self.names[0]]

    @property
    def factor_to_bigger_better(self) -> float:
        """1.0 when a larger value is better, else -1.0 (metric.h:52)."""
        return 1.0 if self.greater_is_better else -1.0


def create_metric(name: str, config: Config) -> Optional[Metric]:
    from . import regression, binary, multiclass, rank, xentropy  # noqa: F401

    if name in ("custom", "none", "null", "na", ""):
        return None
    cls = METRIC_REGISTRY.get(name)
    if cls is None:
        Log.warning("Unknown metric type name: %s", name)
        return None
    return cls(config)
