"""The gang launcher: N worker processes running the CLI, joined through
``torch.distributed`` (the JAX package's ``launch.py``).

    python -m lightgbm_tpu_torch.launch -n 4 -- config=train.conf tree_learner=data

starts 4 workers with MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK /
LOCAL_RANK set (parallel/elastic.py:worker_env); each runs
``python -m lightgbm_tpu_torch.cli`` with the arguments after ``--``, and
parallel/dist.py:init_distributed joins them. A rank's card is
``cuda:{rank % device_count}``; with more ranks than cards they share
them over gloo (dist.pick_backend). For several hosts run the CLI once a
host with that environment, or a machine-list conf, instead.

The gang is supervised (parallel/elastic.py:GangSupervisor): the moment
one worker exits nonzero, or, with ``--liveness-timeout``, its liveness
file ``<gang dir>/hb_<rank>`` goes that many seconds stale, every sibling
is reaped. Each worker is told it runs in a gang (LGBM_TPU_GANG, its
attempt number, the gang directory: a fresh temporary one unless
``--gang-dir`` names one), so its collective watchdog hard-exits (117) out
of a dead collective and an injected ``worker_kill`` exits 43. A worker
writes its liveness file while its elastic runtime is on (``--elastic``,
or LGBM_TPU_COLLECTIVE_TIMEOUT_S in its environment). With ``--elastic`` the
launcher relaunches the gang up to ``--max-restarts`` times, with
``input_model=`` the newest valid ``output_model.snapshot_iter_<k>`` (arm
``snapshot_freq`` for that; rank 0 writes them), at the same world size,
or one rank fewer with ``--allow-shrink``. The exit code is the lost
worker's.
"""
from __future__ import annotations

import argparse
import socket
import tempfile
import subprocess
import sys
from typing import List, Optional

from .parallel.elastic import GangSupervisor, latest_snapshot, worker_env


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _output_model(cli_args: List[str]) -> str:
    # the first occurrence wins, as config.py:kv2map takes it
    for a in cli_args:
        if a.startswith("output_model="):
            return a.split("=", 1)[1]
    return "LightGBM_model.txt"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.launch",
        description="Start N torch.distributed worker processes running the "
                    "lightgbm_tpu_torch CLI")
    parser.add_argument("-n", "--nproc", type=int, default=2, help="worker processes")
    parser.add_argument("--port", type=int, default=0,
                        help="rendezvous port (default: a free one)")
    parser.add_argument("--elastic", action="store_true",
                        help="relaunch the gang after a worker loss, from the newest snapshot")
    parser.add_argument("--max-restarts", type=int, default=2,
                        help="elastic relaunch budget (default 2)")
    parser.add_argument("--allow-shrink", action="store_true",
                        help="elastic restarts drop to one rank fewer")
    parser.add_argument("--liveness-timeout", type=float, default=0.0,
                        help="reap the gang when a worker's liveness file goes stale this "
                             "many seconds (0 = off)")
    parser.add_argument("--gang-dir", default=None,
                        help="directory for the ranks' liveness files (default: a fresh "
                             "temporary one)")
    parser.add_argument("cli_args", nargs=argparse.REMAINDER,
                        help="arguments for lightgbm_tpu_torch.cli (after --)")
    args = parser.parse_args(argv)
    cli_args = [a for a in args.cli_args if a != "--"]
    out_model = _output_model(cli_args)
    gang_dir = args.gang_dir or tempfile.mkdtemp(prefix="lgbm_gang_")
    attempts = {}

    def attempt_args(attempt: int):
        # each relaunch takes a fresh port (the old one may sit in
        # TIME_WAIT) and, past attempt 0, the resume point
        if attempt not in attempts:
            port = (args.port or free_port()) if attempt == 0 else free_port()
            aargs = list(cli_args)
            if attempt > 0:
                snap = latest_snapshot(out_model)
                aargs = [a for a in aargs if not a.startswith("input_model=")]
                if snap:
                    aargs.append(f"input_model={snap}")
                else:
                    print(f"launch: no valid snapshot beside {out_model}; the elastic "
                          "restart trains from the start", file=sys.stderr)
            attempts[attempt] = (port, aargs)
        return attempts[attempt]

    def spawn(world: int, rank: int, attempt: int) -> subprocess.Popen:
        port, aargs = attempt_args(attempt)
        env = worker_env(port=port, world=world, rank=rank, attempt=attempt,
                         gang_dir=gang_dir, elastic=args.elastic)
        return subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch.cli", *aargs],
                                env=env)

    return GangSupervisor(spawn, args.nproc, elastic=args.elastic,
                          max_restarts=args.max_restarts, allow_shrink=args.allow_shrink,
                          liveness_timeout_s=args.liveness_timeout, gang_dir=gang_dir).run()


if __name__ == "__main__":
    sys.exit(main())
