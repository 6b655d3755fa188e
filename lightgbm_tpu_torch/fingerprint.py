"""Environment fingerprint of measurement records.

Counterpart of the JAX package's ``fingerprint.py``. A measurement with no
provenance is noise: a rows/s figure means nothing until one knows which
commit, which torch and CUDA, which card at which power limit, and which
``LGBM_TPU_*`` flags produced it. `fingerprint()` captures exactly that,
cheaply and without ever raising (a capture must not die because git or
nvidia-smi is absent).

`world_fingerprint()` is the identity block a checkpoint sidecar carries
(checkpoint.py), so a restore on another world names both.

The JAX package's `append_ledger` has no counterpart yet: its one caller
there is the benchmark harness, and the port's benchmark is still to come.
"""
from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, Optional

# bump on any breaking change to the record key set
LEDGER_SCHEMA_VERSION = 1


def _git_sha(repo_dir: Optional[str] = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=repo_dir or os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:  # noqa: BLE001 - no git: "unknown"
        pass
    return "unknown"


def _flag_env() -> Dict[str, str]:
    """Every set LGBM_TPU_* flag: the flags are experiment axes."""
    return dict(sorted((k, v) for k, v in os.environ.items() if k.startswith("LGBM_TPU_")))


def card_identity() -> Optional[str]:
    """The first card's ``name, power.limit`` as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    it, or None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except Exception:  # noqa: BLE001 - no nvidia-smi
        pass
    return None


def fingerprint(repo_dir: Optional[str] = None) -> Dict[str, Any]:
    """The environment identity block stamped on every measurement record:
    the git sha, the torch and CUDA versions, the card's name, count and
    power limit (nvidia-smi's strings) and the LGBM_TPU_* flags. Pure
    observation; what it cannot read is "unknown"."""
    fp: Dict[str, Any] = {
        "git_sha": _git_sha(repo_dir),
        "schema_version": LEDGER_SCHEMA_VERSION,
        "flags": _flag_env(),
        "torch_version": "unknown",
        "cuda_version": "unknown",
        "device_kind": "unknown",
        "device_count": 0,
        "backend": "unknown",
        "card": "unknown",
        "power_limit": "unknown",
    }
    try:
        import torch

        fp["torch_version"] = str(torch.__version__)
        fp["cuda_version"] = str(torch.version.cuda)
        if torch.cuda.is_available():
            fp["backend"] = "cuda"
            fp["device_count"] = int(torch.cuda.device_count())
            fp["device_kind"] = str(torch.cuda.get_device_name(0))
        else:
            fp["backend"] = "cpu"
            fp["device_kind"] = "cpu"
    except Exception:  # noqa: BLE001 - no torch on the path
        pass
    line = card_identity()
    if line is not None:
        name, _, limit = line.partition(",")
        fp["card"], fp["power_limit"] = name.strip(), limit.strip() or "unknown"
    return fp


def world_fingerprint(device=None) -> Dict[str, Any]:
    """The world a checkpoint was written in: the process count (the
    gang's size: parallel/dist.py), the mesh shape (one device a rank: the
    gang's size), the device kinds (the
    card's name for a CUDA `device`, else the device type, cpu) and the
    torch and CUDA versions. Pure observation: it never raises, and what it
    cannot read stays "unknown"."""
    fp: Dict[str, Any] = {
        "process_count": 1,
        "mesh_shape": [1],
        "device_kinds": ["unknown"],
        "torch_version": "unknown",
        "cuda_version": "unknown",
    }
    try:
        import torch

        fp["torch_version"] = str(torch.__version__)
        fp["cuda_version"] = str(torch.version.cuda)
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            fp["process_count"] = int(torch.distributed.get_world_size())
            fp["mesh_shape"] = [fp["process_count"]]
        if device is not None:
            dev = torch.device(device)
            fp["device_kinds"] = ([torch.cuda.get_device_name(dev)] if dev.type == "cuda"
                                  else [dev.type])
    except Exception:  # noqa: BLE001 - an observation never fails the caller
        pass
    return fp
