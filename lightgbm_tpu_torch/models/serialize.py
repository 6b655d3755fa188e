"""Whole-model text/JSON serialization, reference format.

Counterpart of src/boosting/gbdt_model_text.cpp: SaveModelToString (:314-413),
LoadModelFromString (:424+), DumpModel JSON (:26-123). The text model file is
the checkpoint + interchange format; matching it field-for-field lets models
round-trip with the reference implementation.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .tree import Tree
from ..checkpoint import atomic_write_text
from ..utils.log import Log

MODEL_VERSION = "v4"


class GBDTModel:
    """The serializable state of a boosted ensemble."""

    def __init__(self) -> None:
        self.name = "tree"  # SubModelName: "tree" for gbdt/rf/dart
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.label_index = 0
        self.max_feature_idx = 0
        self.objective_str: Optional[str] = None
        self.average_output = False
        self.feature_names: List[str] = []
        self.monotone_constraints: List[int] = []
        self.feature_infos: List[str] = []
        self.trees: List[Tree] = []
        self.best_iteration = 0
        self.parameters_str = ""  # `parameters:` section payload
        self.loaded_parameters = ""  # params recovered from a loaded file
        # per-categorical-column pandas category lists (python-package
        # appends `pandas_categorical:<json>` after the parameters section)
        self.pandas_categorical = None

    # ------------------------------------------------------------- properties

    @property
    def num_iterations(self) -> int:
        if self.num_tree_per_iteration <= 0:
            return 0
        return len(self.trees) // self.num_tree_per_iteration

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = 0) -> np.ndarray:
        """GBDT::FeatureImportance: split counts or total gains per feature."""
        n_trees = len(self.trees) if num_iteration <= 0 else min(
            len(self.trees), num_iteration * self.num_tree_per_iteration)
        imp = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for tree in self.trees[:n_trees]:
            ni = tree.num_leaves - 1
            for node in range(ni):
                # reference counts/accumulates only splits with positive gain
                if tree.split_gain[node] <= 0:
                    continue
                f = int(tree.split_feature[node])
                if importance_type == "split":
                    imp[f] += 1.0
                else:
                    imp[f] += float(tree.split_gain[node])
        return imp

    # ------------------------------------------------------------------- save

    def to_string(self, start_iteration: int = 0, num_iteration: int = -1,
                  importance_type: str = "split") -> str:
        lines = [self.name, f"version={MODEL_VERSION}",
                 f"num_class={self.num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 f"label_index={self.label_index}",
                 f"max_feature_idx={self.max_feature_idx}"]
        if self.objective_str:
            lines.append(f"objective={self.objective_str}")
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        if self.monotone_constraints:
            lines.append("monotone_constraints=" + " ".join(str(c) for c in self.monotone_constraints))
        lines.append("feature_infos=" + " ".join(self.feature_infos))

        total_iteration = self.num_iterations
        start_iteration = min(max(start_iteration, 0), total_iteration)
        num_used_model = len(self.trees)
        if num_iteration > 0:
            num_used_model = min((start_iteration + num_iteration) * self.num_tree_per_iteration,
                                 num_used_model)
        start_model = start_iteration * self.num_tree_per_iteration

        tree_strs = []
        for idx, tree in enumerate(self.trees[start_model:num_used_model]):
            tree_strs.append(f"Tree={idx}\n" + tree.to_string() + "\n")
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        out = "\n".join(lines) + "\n"
        out += "".join(tree_strs)
        out += "end of trees\n"

        imp = self.feature_importance(importance_type, num_iteration if num_iteration > 0 else 0)
        pairs = [(int(imp[i]), self.feature_names[i]) for i in range(len(imp)) if int(imp[i]) > 0]
        pairs.sort(key=lambda p: -p[0])
        out += "\nfeature_importances:\n"
        for count, fname in pairs:
            out += f"{fname}={count}\n"
        params = self.parameters_str or self.loaded_parameters
        if params:
            out += "\nparameters:\n" + params + "\nend of parameters\n"
        if self.pandas_categorical is not None:
            out += ("pandas_categorical:"
                    + json.dumps(self.pandas_categorical, default=str) + "\n")
        return out

    def save_to_file(self, filename: str, start_iteration: int = 0,
                     num_iteration: int = -1, importance_type: str = "split") -> None:
        # atomic (temp + fsync + os.replace): a crash mid-save can never
        # leave a truncated model file behind
        atomic_write_text(filename,
                          self.to_string(start_iteration, num_iteration,
                                         importance_type))

    # ------------------------------------------------------------------- load

    @classmethod
    def from_string(cls, text: str, source: str = "<string>") -> "GBDTModel":
        model = cls()
        lines = text.split("\n")
        i = 0
        key_vals: Dict[str, str] = {}
        while i < len(lines):
            line = lines[i].rstrip("\r")
            if line.startswith("Tree="):
                break
            if line:
                if "=" in line:
                    key, val = line.split("=", 1)
                    key_vals[key] = val
                else:
                    key_vals[line] = ""
            i += 1
        if "num_class" not in key_vals:
            Log.fatal("Model file %s is truncated or corrupt: missing "
                      "header key num_class", source)
        if "max_feature_idx" not in key_vals:
            Log.fatal("Model file %s is truncated or corrupt: missing "
                      "header key max_feature_idx", source)
        model.name = lines[0].strip() or "tree"
        try:
            model.num_class = int(key_vals["num_class"])
            model.num_tree_per_iteration = int(key_vals.get("num_tree_per_iteration", model.num_class))
            model.label_index = int(key_vals.get("label_index", 0))
            model.max_feature_idx = int(key_vals["max_feature_idx"])
        except ValueError as exc:
            Log.fatal("Model file %s is truncated or corrupt: garbled "
                      "header value (%s)", source, exc)
        model.average_output = "average_output" in key_vals
        model.objective_str = key_vals.get("objective") or None
        model.feature_names = key_vals.get("feature_names", "").split()
        if len(model.feature_names) != model.max_feature_idx + 1:
            Log.fatal("Model file %s: wrong size of feature_names (%d names "
                      "for max_feature_idx=%d)", source,
                      len(model.feature_names), model.max_feature_idx)
        model.feature_infos = key_vals.get("feature_infos", "").split()
        if "monotone_constraints" in key_vals and key_vals["monotone_constraints"]:
            model.monotone_constraints = [int(x) for x in key_vals["monotone_constraints"].split()]

        # tree sections
        saw_end = False
        while i < len(lines):
            line = lines[i].rstrip("\r")
            if line.startswith("end of trees"):
                saw_end = True
                i += 1
                break
            if line.startswith("Tree="):
                i += 1
                tree_kv: Dict[str, str] = {}
                while i < len(lines):
                    tline = lines[i].rstrip("\r")
                    if not tline or tline.startswith("Tree=") or tline.startswith("end of trees"):
                        break
                    if "=" in tline:
                        k, v = tline.split("=", 1)
                        tree_kv[k] = v
                    i += 1
                try:
                    model.trees.append(Tree.from_key_values(tree_kv))
                except (KeyError, ValueError, IndexError) as exc:
                    Log.fatal("Model file %s is truncated or corrupt: tree "
                              "%d has a missing or garbled key (%s)",
                              source, len(model.trees), exc)
            else:
                i += 1
        expected_trees = len(key_vals.get("tree_sizes", "").split())
        if not saw_end or len(model.trees) != expected_trees:
            Log.fatal("Model file %s is truncated or corrupt: header "
                      "declares %d trees but %d parsed%s", source,
                      expected_trees, len(model.trees),
                      "" if saw_end else " and the 'end of trees' marker "
                      "is missing")
        # parameters section
        if "parameters:" in text:
            start = text.index("parameters:") + len("parameters:")
            end = text.find("end of parameters", start)
            if end >= 0:
                model.loaded_parameters = text[start:end].strip()
        # python-package pandas category lists (trailing json line)
        marker = "pandas_categorical:"
        pos = text.rfind("\n" + marker)
        if pos >= 0:
            line = text[pos + 1 + len(marker):].splitlines()[0].strip()
            if line and line != "null":
                try:
                    model.pandas_categorical = json.loads(line)
                except ValueError:
                    pass
        return model

    @classmethod
    def from_file(cls, filename: str) -> "GBDTModel":
        try:
            with open(filename) as fh:
                text = fh.read()
        except OSError as exc:
            Log.fatal("Cannot read model file %s: %s", filename, exc)
        return cls.from_string(text, source=filename)

    # ------------------------------------------------------------------- JSON

    def dump_json(self, start_iteration: int = 0, num_iteration: int = -1,
                  importance_type: str = "split") -> str:
        """GBDT::DumpModel (gbdt_model_text.cpp:26-123): the header, each
        tree's JSON and the feature importances, as one JSON string."""
        num_used_model = len(self.trees)
        if num_iteration > 0:
            num_used_model = min((start_iteration + num_iteration) * self.num_tree_per_iteration,
                                 num_used_model)
        start_model = start_iteration * self.num_tree_per_iteration
        tree_infos = ['{"tree_index":%d,%s}' % (idx - start_model,
                                               self.trees[idx].to_json()[1:-1])
                      for idx in range(start_model, num_used_model)]
        imp = self.feature_importance(importance_type,
                                      num_iteration if num_iteration > 0 else 0)
        pairs = [(int(imp[i]), self.feature_names[i]) for i in range(len(imp))
                 if int(imp[i]) > 0]
        pairs.sort(key=lambda p: -p[0])
        feat_imp = ",".join(f'"{n}":{c}' for c, n in pairs)
        feature_infos_json = []
        for info in self.feature_infos:
            if info.startswith("["):
                lo, hi = info[1:-1].split(":")
                feature_infos_json.append({"min_value": float(lo), "max_value": float(hi),
                                           "values": []})
            elif info == "none":
                feature_infos_json.append({"min_value": 0, "max_value": 0, "values": []})
            else:
                vals = [int(float(x)) for x in info.split(":")]
                feature_infos_json.append({"min_value": min(vals), "max_value": max(vals),
                                           "values": vals})
        head = {
            "name": self.name,
            "version": MODEL_VERSION,
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_index,
            "max_feature_idx": self.max_feature_idx,
        }
        if self.objective_str:
            head["objective"] = self.objective_str
        head["average_output"] = self.average_output
        head["feature_names"] = self.feature_names
        head["monotone_constraints"] = self.monotone_constraints
        head["feature_infos"] = {n: fi for n, fi in zip(self.feature_names, feature_infos_json)}
        out = json.dumps(head)[:-1] + ',"tree_info":[' + ",".join(tree_infos) + '],'
        return out + '"feature_importances":{' + feat_imp + "}}"
