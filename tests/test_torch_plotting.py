"""The plots (`plotting.py`) against the JAX package's, drawn with
matplotlib's Agg backend from Boosters of both packages loaded from one
model text the port trains on the CPU.

Contract: each plot's bars (positions, sizes), lines, tick labels, titles,
axis labels and texts are equal to the JAX package's; the names are
exported lazily by the package.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from tests.test_torch_ref import jax_ref  # noqa: F401

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

CPU = {"device_type": "cpu", "verbosity": -1}


@pytest.fixture(scope="module")
def model():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(800, 5))
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 3] > 0).astype(float)
    evals = {}
    ds = lt.Dataset(X, label=y, feature_name=[f"feat_{i}" for i in range(5)])
    bst = lt.train({"objective": "binary", "num_leaves": 7, "metric": "auc", **CPU}, ds,
                   num_boost_round=5, valid_sets=[lt.Dataset(X[:200], label=y[:200],
                                                             reference=ds)],
                   valid_names=["v"], callbacks=[lt.record_evaluation(evals)])
    return bst.model_to_string(), evals


def _content(ax):
    bars = [(round(p.get_x(), 12), round(p.get_y(), 12), round(p.get_width(), 12),
             round(p.get_height(), 12)) for p in ax.patches]
    lines = [(tuple(line.get_xdata()), tuple(line.get_ydata())) for line in ax.get_lines()]
    texts = [(t.get_text(), tuple(np.round(t.get_position(), 12))) for t in ax.texts]
    return {"bars": bars, "lines": lines, "texts": texts, "title": ax.get_title(),
            "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "yticks": [t.get_text() for t in ax.get_yticklabels()]}


def _both(jax_ref, model, draw):
    from lightgbm_tpu import plotting as ref_plotting

    from lightgbm_tpu_torch import plotting

    text, _ = model
    port = draw(plotting, lt.Booster(model_str=text, params=CPU))
    ref = draw(ref_plotting, jax_ref.Booster(model_str=text, params=CPU))
    out = _content(port), _content(ref)
    plt.close("all")
    return out


@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_plot_importance(jax_ref, model, importance_type):
    port, ref = _both(jax_ref, model, lambda m, b: m.plot_importance(
        b, importance_type=importance_type, max_num_features=4))
    assert port == ref and port["bars"] and port["yticks"]


def test_plot_metric(jax_ref, model):
    from lightgbm_tpu import plotting as ref_plotting

    from lightgbm_tpu_torch import plotting

    _, evals = model
    port, ref = _content(plotting.plot_metric(evals)), _content(ref_plotting.plot_metric(evals))
    plt.close("all")
    assert port == ref and port["ylabel"] == "auc" and len(port["lines"][0][1]) == 5


def test_plot_split_value_histogram(jax_ref, model):
    port, ref = _both(jax_ref, model,
                      lambda m, b: m.plot_split_value_histogram(b, "feat_0", bins=5))
    assert port == ref and len(port["bars"]) == 5


def test_plot_tree(jax_ref, model):
    port, ref = _both(jax_ref, model, lambda m, b: m.plot_tree(b, tree_index=1))
    assert port == ref and any("leaf" in t for t, _ in port["texts"])


def test_plots_are_exported_lazily():
    assert lt.plot_importance.__module__ == "lightgbm_tpu_torch.plotting"
    assert callable(lt.plot_tree) and callable(lt.plot_metric)
