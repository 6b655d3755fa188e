"""Ranking data and grid-snapped lambdarank gradients shared by the port's
CPU parity tests and its card tests (it imports nothing of the JAX
package, so the card's test run, which has no JAX, can import it)."""
import numpy as np
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.objectives import create_objective

N_POSITIONS = 10


def rank_data(seed=0, n_queries=60, n_features=6):
    """(X, labels 0-4, query sizes): queries of 5-40 documents, labels cut
    from a linear relevance signal plus noise."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(5, 41, size=n_queries)
    n = int(sizes.sum())
    X = rng.normal(size=(n, n_features))
    rel = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] + 0.5 * rng.normal(size=n)
    y = np.clip(np.floor(rel + 1.5), 0, 4)
    return X, y, sizes


def shown_positions(sizes):
    """Each document's rank in its query's shown list, capped at
    N_POSITIONS - 1 (the click logs' position ids)."""
    return np.concatenate([np.minimum(np.arange(s), N_POSITIONS - 1) for s in sizes])


class SnappedLambdarank:
    """lambdarank gradients of the port's objective on the host's CPU,
    snapped to a 2**-8 grid (hessians at least 2**-8): every histogram and
    split sum of them is exact in float32, whatever the summation order, so
    any two learners grow the same trees from the same gradients."""

    def __init__(self):
        self.obj = None

    def __call__(self, preds, dataset):
        if self.obj is None:
            md = Metadata(len(preds))
            md.set_label(dataset.get_label())
            md.set_query(dataset.get_group())
            self.obj = create_objective("lambdarank", Config({"objective": "lambdarank"}))
            self.obj.init(md, len(preds), torch.device("cpu"))
        scores = np.array(preds, dtype=np.float32)
        g, h = self.obj.get_gradients(torch.from_numpy(scores))
        return (np.round(g.numpy().astype(np.float64) * 256) / 256,
                np.round(np.maximum(h.numpy().astype(np.float64), 1 / 256) * 256) / 256)
