"""Multi-model registry with checksum-verified, atomic hot-swap.

Every load stages a COMPLETE candidate — raw text read (or exported),
content-hashed, verified against the writer's ``.ckpt`` sidecar manifest
(checkpoint.py) and/or an explicit expected sha256, and parsed into a fresh
Booster on the service's device — before a single dict assignment under
the registry lock publishes it. A corrupt upload therefore can never
replace a serving model: it fails the hash or the parse while the previous
version keeps answering traffic. Loads are idempotent (same bytes already
serving -> the live entry is returned unchanged), so a client retrying a
timed-out upload cannot double-bump the version.

Before it is published, a version predicts one row on the service's
device: on the card that builds and launches the traversal kernel, so a
kernel that fails to build or to launch fails the load (ModelLoadError)
and never reaches live traffic or the circuit breaker.

There is no host path: an entry predicts on the service's device only.
A dispatch that fails on the card fails its batch and feeds the circuit
breaker (batcher.py). Loads, swaps and rejected uploads are telemetry
events.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import checkpoint, telemetry, tracing
from ..basic import Booster
from ..utils import faults
from ..utils.log import Log
from ..utils.timer import global_timer
from .errors import ModelLoadError, ModelNotFound


class ModelEntry:
    """One immutable serving version of one named model."""

    def __init__(self, name: str, booster: Booster, sha256: str,
                 verified: bool, reject_nonfinite: bool) -> None:
        self.name = name
        self.booster = booster
        self.sha256 = sha256
        self.verified = verified
        self.reject_nonfinite = reject_nonfinite
        self.version = 0  # assigned at publish time
        self.loaded_unix = time.time()
        self.n_features = booster.num_feature()

    def predict(self, X: np.ndarray, raw_score: bool) -> np.ndarray:
        return self.booster.predict(X, raw_score=raw_score)

    def info(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "version": self.version,
            "sha256": self.sha256,
            "verified": self.verified,
            "n_features": self.n_features,
            "num_trees": self.booster.num_trees(),
            "reject_nonfinite": self.reject_nonfinite,
            "device": str(self.booster.device),
            "loaded_unix": self.loaded_unix,
        }


class ModelRegistry:
    """Thread-safe name -> ModelEntry map; swap is one assignment. Every
    entry's Booster runs on `device`."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._models: Dict[str, ModelEntry] = {}
        self.rejected_uploads = 0
        self.swaps = 0

    # ---------------------------------------------------------------- load

    def load(self, name: str, path: Optional[str] = None,
             model_str: Optional[str] = None,
             booster: Optional[Booster] = None,
             reject_nonfinite: bool = False,
             expected_sha256: Optional[str] = None) -> ModelEntry:
        """Stage + verify + parse + publish. Exactly one source among
        `path` / `model_str` / `booster`; an in-process Booster is
        snapshotted through its text export so the served version stays
        immutable."""
        if sum(x is not None for x in (path, model_str, booster)) != 1:
            raise ModelLoadError(
                "exactly one of path / model_str / booster must be given")
        if path is not None:
            try:
                with open(path) as fh:
                    text = fh.read()
            except OSError as exc:
                self._reject(name, f"unreadable model file: {exc}")
        elif booster is not None:
            text = booster.model_to_string()
        else:
            text = model_str or ""
        # the transit-corruption fault point sits BEFORE verification, so an
        # armed model_corrupt_upload exercises the reject path for real
        text = faults.maybe_corrupt_upload(text)
        sha = hashlib.sha256(text.encode()).hexdigest()

        verified = False
        if path is not None:
            try:
                manifest = checkpoint.read_sidecar_manifest(path)
            except checkpoint.CheckpointError as exc:
                self._reject(name, f"damaged checkpoint sidecar: {exc}")
            if manifest is not None:
                want = manifest.get("model_sha256")
                if want and want != sha:
                    self._reject(
                        name, "upload does not match the sidecar's content "
                        f"hash (sidecar {str(want)[:12]}.., staged "
                        f"{sha[:12]}..)")
                verified = True
        if expected_sha256 is not None:
            if expected_sha256.lower() != sha:
                self._reject(
                    name, f"upload hash {sha[:12]}.. does not match "
                    f"expected {expected_sha256[:12]}..")
            verified = True

        with self._lock:
            cur = self._models.get(name)
            if cur is not None and cur.sha256 == sha:
                Log.info("serving: model '%s' v%d already serving these "
                         "bytes; load is a no-op", name, cur.version)
                return cur

        # parse OUTSIDE the lock: a big model text should not stall predicts
        try:
            staged = Booster(model_str=text,
                             params={"device_type": str(self.device)})
        except Exception as exc:  # noqa: BLE001 - any parse failure rejects
            self._reject(name, f"unparseable model text: {exc}")
        entry = ModelEntry(name, staged, sha, verified, reject_nonfinite)
        # one row through the traversal before publishing: on the card that
        # builds and launches the kernel, so a kernel that cannot run fails
        # the load here, never a live request
        try:
            entry.predict(np.zeros((1, max(entry.n_features, 1)), dtype=np.float32), True)
        except Exception as exc:  # noqa: BLE001 - any launch failure fails the load
            Log.warning("serving: model '%s' failed its load-time launch on %s: %s",
                        name, self.device, exc)
            tracing.note("model_load_launch_failed", model=name, error=repr(exc)[:400])
            if telemetry.enabled():
                telemetry.emit("model_load_launch_failed", model=name, error=str(exc))
            raise ModelLoadError(f"model '{name}': the traversal failed to launch on "
                                 f"{self.device}: {exc}") from exc

        with self._lock:
            cur = self._models.get(name)
            if cur is not None and cur.sha256 == sha:
                return cur  # racing identical upload won
            entry.version = cur.version + 1 if cur is not None else 1
            self._models[name] = entry
            self.swaps += 1
        Log.info("serving: model '%s' -> v%d (%d trees, sha %s%s)",
                 name, entry.version, entry.booster.num_trees(), sha[:12],
                 ", verified" if verified else "")
        tracing.note("model_swap", model=name, version=entry.version,
                     sha256=sha[:12], verified=verified)
        if telemetry.enabled():
            telemetry.emit("model_swap", model=name, version=entry.version,
                           sha256=sha[:12], verified=verified,
                           num_trees=entry.booster.num_trees())
        return entry

    def _reject(self, name: str, why: str) -> None:
        with self._lock:
            self.rejected_uploads += 1
        global_timer.add_count("serve_rejected_uploads", 1)
        Log.warning("serving: REJECTED upload for model '%s': %s", name, why)
        tracing.note("model_upload_rejected", model=name, reason=why)
        if telemetry.enabled():
            telemetry.emit("model_upload_rejected", model=name, reason=why)
        raise ModelLoadError(f"model '{name}': {why}")

    # -------------------------------------------------------------- lookup

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise ModelNotFound(f"no model registered under '{name}'")
        return entry

    def unload(self, name: str) -> bool:
        with self._lock:
            return self._models.pop(name, None) is not None

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def info(self) -> List[Dict[str, Any]]:
        with self._lock:
            entries = list(self._models.values())
        return [e.info() for e in sorted(entries, key=lambda e: e.name)]
