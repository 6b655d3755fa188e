"""Regression data whose L2 gradients are exact, shared by the port's CPU
parity tests and its card tests (it imports nothing of the JAX package, so
the card's test run, which has no JAX, can import it)."""
import numpy as np


def grid_regression(seed=0, n=2000, f=8):
    """Rows in +/- pairs and labels 1 + s with s on a 1/64 grid, odd in the
    rows: the labels' mean, boost-from-average's init score, is exactly 1,
    so every gradient init - label is on the grid and every sum of them
    exact."""
    rng = np.random.RandomState(seed)
    half = rng.normal(size=(n // 2, f))
    X = np.concatenate([half, -half])
    s = np.round((X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] ** 3) * 64) / 64
    y = 1.0 + s
    assert float(np.mean(y)) == 1.0
    return X, y
