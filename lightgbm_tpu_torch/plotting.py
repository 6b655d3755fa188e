"""Plotting utilities (matplotlib).

Counterpart of the JAX package's ``plotting.py`` (python-package/lightgbm/
plotting.py): feature-importance bars, recorded-metric curves, split-value
histograms and tree diagrams, over the Booster's ``feature_importance`` and
``dump_model``. Trees are drawn with matplotlib annotations rather than
graphviz. matplotlib is imported inside each function, and the package
exports these names lazily, so the package imports without it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster


def _check_not_tuple_of_2_elements(obj: Any, obj_name: str) -> None:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a list/tuple of length 2.")


def _get_booster(booster) -> Booster:
    if isinstance(booster, Booster):
        return booster
    if hasattr(booster, "booster_"):
        return booster.booster_
    raise TypeError("booster must be Booster or LGBMModel.")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple] = None, ylim: Optional[Tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: int = 3, **kwargs):
    """Horizontal bar chart of split/gain importances (plotting.py:36)."""
    import matplotlib.pyplot as plt

    bst = _get_booster(booster)
    if importance_type == "auto":
        importance_type = "split"
    importance = bst.feature_importance(importance_type=importance_type)
    feature_name = bst.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")
    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain" else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster: Union[Dict, Any], metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None, title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "@metric@",
                figsize=None, dpi=None, grid: bool = True):
    """Plot metric curves from record_evaluation results (plotting.py:193)."""
    import matplotlib.pyplot as plt

    if isinstance(booster, dict):
        eval_results = booster
    elif hasattr(booster, "evals_result_"):
        eval_results = booster.evals_result_
    else:
        raise TypeError(
            "booster must be dict (from record_evaluation) or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    names = dataset_names or list(eval_results.keys())
    first = eval_results[names[0]]
    if metric is None:
        metric = list(first.keys())[0]
    for name in names:
        results = eval_results[name][metric]
        ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel.replace("@metric@", metric))
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature: Union[int, str], bins=None,
                               ax=None, width_coef: float = 0.8, xlim=None,
                               ylim=None,
                               title: str = "Split value histogram for "
                                            "feature with @index/name@ @feature@",
                               xlabel: str = "Feature split value",
                               ylabel: str = "Count", figsize=None, dpi=None,
                               grid: bool = True):
    """Histogram of a feature's split thresholds (plotting.py:299)."""
    import matplotlib.pyplot as plt

    bst = _get_booster(booster)
    model = bst.dump_model()
    feature_name = bst.feature_name()
    if isinstance(feature, str):
        fidx = feature_name.index(feature)
        ftag = "name"
    else:
        fidx = int(feature)
        ftag = "index"
    values: List[float] = []

    def collect(node: Dict) -> None:
        if "split_feature" in node:
            if node["split_feature"] == fidx and node.get(
                    "decision_type") == "<=":
                values.append(node["threshold"])
            collect(node["left_child"])
            collect(node["right_child"])

    for tree in model["tree_info"]:
        collect(tree["tree_structure"])
    if not values:
        raise ValueError(
            f"Cannot plot split value histogram, "
            f"as feature {feature} was not used in splitting.")
    hist, bin_edges = np.histogram(values, bins=bins if bins else "auto")
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ax.bar(centers, hist,
           width=width_coef * (bin_edges[1] - bin_edges[0]))
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    title = title.replace("@index/name@", ftag).replace(
        "@feature@", str(feature))
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_tree(booster, tree_index: int = 0, ax=None, figsize=None, dpi=None,
              show_info: Optional[List[str]] = None,
              precision: int = 3, orientation: str = "horizontal", **kwargs):
    """Render one tree as a matplotlib annotation diagram (the reference
    renders via graphviz, plotting.py:606; same node content)."""
    import matplotlib.pyplot as plt

    bst = _get_booster(booster)
    model = bst.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range.")
    tree = model["tree_info"][tree_index]["tree_structure"]
    feature_name = bst.feature_name()

    # lay out leaves on one axis, depth on the other
    positions: Dict[int, Tuple[float, float]] = {}
    labels: Dict[int, str] = {}
    edges: List[Tuple[int, int, str]] = []
    counter = [0, 0.0]

    def walk(node: Dict, depth: int) -> int:
        nid = counter[0]
        counter[0] += 1
        if "split_feature" in node:
            lid = walk(node["left_child"], depth + 1)
            rid = walk(node["right_child"], depth + 1)
            x = (positions[lid][0] + positions[rid][0]) / 2
            positions[nid] = (x, -depth)
            f = feature_name[node["split_feature"]]
            labels[nid] = (f"{f}\n<= {node['threshold']:.{precision}g}\n"
                           f"gain: {node.get('split_gain', 0):.{precision}g}")
            edges.append((nid, lid, "yes"))
            edges.append((nid, rid, "no"))
        else:
            positions[nid] = (counter[1], -depth)
            counter[1] += 1.0
            labels[nid] = (f"leaf {node.get('leaf_index', 0)}\n"
                           f"{node.get('leaf_value', 0):.{precision}g}")
        return nid

    walk(tree, 0)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize or (12, 8), dpi=dpi)
    for parent, child, tag in edges:
        x0, y0 = positions[parent]
        x1, y1 = positions[child]
        ax.plot([x0, x1], [y0, y1], "-", color="gray", zorder=1)
        ax.annotate(tag, ((x0 + x1) / 2, (y0 + y1) / 2), fontsize=8,
                    color="blue")
    for nid, (x, y) in positions.items():
        ax.annotate(labels[nid], (x, y), ha="center", va="center",
                    bbox=dict(boxstyle="round", fc="lightyellow", ec="gray"),
                    fontsize=8, zorder=2)
    ax.axis("off")
    return ax
