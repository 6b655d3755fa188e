"""The distributed layer (the JAX package's ``parallel/``), over
``torch.distributed`` with one process a rank:

  tree_learner=data    -> DeviceDataParallelTreeLearner (the wave learner,
                          rows sharded, histogram images reduce-scattered
                          over feature blocks) or DataParallelTreeLearner
                          (host-driven: every lane the wave refuses)
  tree_learner=feature -> DeviceFeatureParallelTreeLearner /
                          FeatureParallelTreeLearner (rows replicated, the
                          scan sharded over features)
  tree_learner=voting  -> VotingDataParallelTreeLearner /
                          VotingParallelTreeLearner (PV-Tree)

`dist` joins the gang and holds the collectives, `mesh` the `World`,
`predict` the row-sharded prediction, `elastic` the launcher's gang
supervision (``python -m lightgbm_tpu_torch.launch``). The learners load
lazily, from the tree learner factory.
"""
from .elastic import WorkerLostError

__all__ = ["WorkerLostError"]
