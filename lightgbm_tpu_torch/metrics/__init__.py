from .registry import create_metric, Metric, METRIC_REGISTRY

__all__ = ["create_metric", "Metric", "METRIC_REGISTRY"]
