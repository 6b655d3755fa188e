"""Out-of-core streaming and the continuous-training flywheel, on one card.

Counterpart of the JAX package's ``streaming/`` (docs/STREAMING.md):

  * ingest.py     RowBlockStore: incremental row pushes (numpy blocks, CSR
                  chunks, chunked CSV files, iterators, and the C API's
                  LGBM_DatasetPushRows* in capi/impl.py), binned block by
                  block against a layout fitted on a sample prefix.
  * learner.py    StreamedTreeLearner: trains with LGBM_TPU_HBM_BUDGET
                  bytes of the bin plane on the card, uploading blocks on a
                  copy stream while the leaf histogram's carried mode sums
                  the leaf block by block; bit-identical to the resident
                  serial learner.
  * continuous.py ContinuousTrainer: refits on fresh rows, crash-consistent
                  checkpoints, a holdout quality gate with generation
                  rollback, hot swap (optionally canaried) into serving.
  * drift.py      DriftMonitor: per-feature quantile sketches and PSI
                  scores against the binning-time reference, driving alarms
                  and the bin-mapper refresh (LGBM_TPU_DRIFT,
                  LGBM_TPU_BIN_REFRESH_EVERY).
  * sharded.py    the gang: ShardedRowBlockStore (round-robin placement,
                  the layout fit from rank-merged sketches), PodDriftMonitor
                  (drift merged across the ranks) and
                  ShardedStreamedTreeLearner (tree_learner=data under the
                  budget: each rank caches the blocks it owns and the
                  ranks add the carried histograms' images exactly).
"""
import importlib

# each name from its module, imported when first asked for: the tree
# learner's factory loads learner.py alone, not the trainer above it
_MODULES = {
    "ContinuousTrainer": "continuous",
    "GenerationRejected": "continuous",
    "DriftMonitor": "drift",
    "QuantileSketch": "drift",
    "merge_ranked": "drift",
    "RowBlockStore": "ingest",
    "wrap_dataset": "ingest",
    "StreamedTreeLearner": "learner",
    "PodDriftMonitor": "sharded",
    "ShardedRowBlockStore": "sharded",
    "ShardedStreamedTreeLearner": "sharded",
    "stream_budget_bytes": "learner",
    "streaming_requested": "learner",
}


def __getattr__(name):
    if name in _MODULES:
        return getattr(importlib.import_module(f".{_MODULES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ContinuousTrainer",
    "DriftMonitor",
    "GenerationRejected",
    "PodDriftMonitor",
    "QuantileSketch",
    "RowBlockStore",
    "ShardedRowBlockStore",
    "ShardedStreamedTreeLearner",
    "StreamedTreeLearner",
    "merge_ranked",
    "stream_budget_bytes",
    "streaming_requested",
    "wrap_dataset",
]
