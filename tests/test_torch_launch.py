"""Joining a gang and the launcher (lightgbm_tpu_torch/parallel/dist.py,
parallel/elastic.py, launch.py), on the CPU over gloo.

Contracts:
* `rendezvous` resolves explicit arguments before the MASTER_* / RANK /
  WORLD_SIZE environment before the conf's machine list (the first machine
  the rendezvous at local_listen_port, the rank this host's line), and
  nothing when none names a gang; `init_distributed` from a machine list
  joins two processes over gloo;
* `pick_backend`: gloo on the CPU, nccl while a host's ranks (a machine
  list's lines that name it) have a card each; `agree_backend`: gloo for
  the gang when any rank picked it;
* `python -m lightgbm_tpu_torch.launch -n 2 -- <cli args>
  tree_learner=data` (and feature) trains the single-process CLI's model
  (quantized gradients: integer histograms, exact in any order), and
  voting one round of float L2 gradients on a 1/64 grid, rank 0 writing
  it; with --elastic a gang whose rank dies resumes from rank 0's
  snapshot and writes the same model;
* GangSupervisor on stub workers, as the JAX package's tests/test_elastic.py:
  150-236 hold its own: reap on first loss, the elastic restart and its
  budget, shrink, a stale liveness file; `worker_env`'s block;
  `latest_snapshot` skips a torn sidecar;
* the int16 pair wire: packed sums over ranks unpack to the sums.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli, launch
from lightgbm_tpu_torch.checkpoint import checkpoint_callback
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import dist
from lightgbm_tpu_torch.parallel.elastic import GangSupervisor, latest_snapshot, worker_env
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.torch_gang import run_gang
from tests.torch_grid_data import grid_regression

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _keep_log_verbosity():
    """cli.run sets the process's log verbosity (verbosity=-1 in these
    arguments): put it back, so the next file's tests log as by default."""
    from lightgbm_tpu_torch.utils import log

    before = log._verbosity
    yield
    log.set_verbosity(before)


def test_rendezvous_resolution_order(tmp_path, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert dist.rendezvous(Config({})) is None
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 12400\n10.0.0.2 12400\n10.0.0.3 12400\n")
    cfg = Config({"machine_list_filename": str(mlist), "local_listen_port": 23456})
    # the first machine is the rendezvous; this host's line is the rank
    assert dist.rendezvous(cfg) == ("127.0.0.1", 23456, 3, 0, 0, 1)
    cfg_m = Config({"machines": "10.0.0.9:1,127.0.0.1:2", "local_listen_port": 777})
    assert dist.rendezvous(cfg_m) == ("10.0.0.9", 777, 2, 1, 0, 1)
    # the environment before the conf
    monkeypatch.setenv("MASTER_ADDR", "10.1.1.1")
    monkeypatch.setenv("MASTER_PORT", "999")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dist.rendezvous(cfg) == ("10.1.1.1", 999, 4, 3, 1, 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert dist.rendezvous(cfg)[5] == 2
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    # explicit arguments before both
    assert dist.rendezvous(cfg, master_addr="h", master_port=5, world_size=2, rank=1) == \
        ("h", 5, 2, 1, 1, 2)
    monkeypatch.delenv("RANK")
    with pytest.raises(LightGBMError, match="rank"):
        dist.rendezvous(Config({}))


def test_backend_is_named(monkeypatch):
    """gloo on the CPU; on cards nccl while the host's ranks have a card
    each; the gang takes gloo when any rank picked it."""
    assert dist.pick_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.pick_backend("cpu", 1) == "gloo"
    assert [dist.pick_backend("cuda", n) for n in (1, 2, 3)] == ["nccl", "nccl", "gloo"]
    for picks, want in ((["nccl", "nccl"], "nccl"), (["nccl", "gloo"], "gloo")):
        store = torch.distributed.HashStore()
        store.set("lgbm_backend/1", picks[1])
        assert dist.agree_backend(store, 0, 2, picks[0]) == want


@pytest.mark.parametrize("rank,local", [(0, (0, 2)), (1, (0, 2)), (2, (1, 2)), (3, (1, 2)),
                                        (4, (0, 1))])
def test_machine_list_local_size_picks_the_backend(monkeypatch, tmp_path, rank, local):
    """One line a rank: a host's local rank and size count the lines that
    name it, so two ranks on a host with two cards take nccl and three
    would not."""
    for k in ("MASTER_ADDR", "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("10.0.0.1 1\n10.0.0.2 1\n10.0.0.1 2\n10.0.0.2 2\n10.0.0.3 1\n")
    found = dist.rendezvous(Config({"machine_list_filename": str(mlist)}), rank=rank)
    assert found[:4] == ("10.0.0.1", 12400, 5, rank) and found[4:] == local
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.pick_backend("cuda", found[5]) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist.pick_backend("cuda", found[5]) == ("nccl" if local[1] == 1 else "gloo")


def test_init_distributed_from_a_machine_list(tmp_path):
    port = launch.free_port()
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1\n127.0.0.1\n")
    out = run_gang("join_machine_list", 2, tmp_path, str(mlist), port, join=False)
    assert [o[:4] for o in out] == [(True, 2, 0, "gloo"), (True, 2, 1, "gloo")]
    assert [o[4] for o in out] == [3, 3]


def test_num_machines_without_a_gang_names_the_launcher():
    from lightgbm_tpu_torch.parallel.mesh import data_world

    with pytest.raises(LightGBMError, match="lightgbm_tpu_torch.launch -n 3"):
        data_world(3)
    assert data_world(1).size == 1


def _grid_files(tmp_path):
    X, y = grid_regression(0, n=1600, f=6)
    path = str(tmp_path / "train.tsv")
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.17g")
    return path


def _cli_args(data, out, *extra, quantized=True, rounds=4):
    # quantized gradients: integer histograms, whose sums are exact in any
    # order on the CPU too
    return ["task=train", f"data={data}", "objective=regression", "num_leaves=15",
            f"num_iterations={rounds}", "device_type=cpu", "verbosity=-1",
            "min_data_in_leaf=5", f"use_quantized_grad={str(quantized).lower()}",
            "num_grad_quant_bins=8", f"output_model={out}", *extra]


@pytest.mark.parametrize("learner", ["data", "feature", "voting"])
def test_two_process_cli_trains_the_single_process_model(tmp_path, monkeypatch, learner):
    data = _grid_files(tmp_path)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    gang_out = str(tmp_path / "gang.txt")
    # the host-driven voting learner takes float gradients only (as the JAX
    # package's): its top_k >= F election, one round on the grid labels' L2
    # gradients, whose sums are exact in any order
    voting = learner == "voting"
    kw = {"quantized": not voting, "rounds": 1 if voting else 4}
    rc = launch.main(["-n", "2", "--",
                      *_cli_args(data, gang_out, f"tree_learner={learner}", "top_k=20", **kw)])
    assert rc == 0
    assert cli.run(_cli_args(data, str(tmp_path / "one.txt"), **kw)) == 0
    got = open(gang_out).read()
    want = open(tmp_path / "one.txt").read()
    assert got.split("end of trees")[0] == want.split("end of trees")[0]
    assert got.count("Tree=") == (1 if learner == "voting" else 4)


def test_elastic_launch_resumes_the_gang_from_its_snapshot(tmp_path, monkeypatch):
    """launch --elastic: rank 1 of the first gang is killed at the start of
    iteration 3 (the kill@3 fault token in its environment alone); the
    supervisor reaps rank 0, relaunches both with input_model= the
    snapshot of iteration 2 that rank 0 wrote, and the resumed gang writes
    the single-process model."""
    data = _grid_files(tmp_path)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    started = []
    popen = subprocess.Popen

    def spawn(cmd, env, **kw):
        resumed = [a for a in cmd if a.startswith("input_model=")]
        started.append((env["RANK"], resumed))
        if env["RANK"] == "1" and not resumed:
            env = dict(env, LGBM_TPU_FAULT="kill@3")
        return popen(cmd, env=env, **kw)

    monkeypatch.setattr(launch.subprocess, "Popen", spawn)
    out = str(tmp_path / "gang.txt")
    args = _cli_args(data, out, "tree_learner=data", "snapshot_freq=2", rounds=5)
    assert launch.main(["-n", "2", "--elastic", "--max-restarts", "1", "--", *args]) == 0
    snap = f"input_model={out}.snapshot_iter_2"
    assert sorted(started) == [("0", []), ("0", [snap]), ("1", []), ("1", [snap])]
    assert cli.run(_cli_args(data, str(tmp_path / "one.txt"), rounds=5)) == 0
    got = open(out).read()
    assert got.split("end of trees")[0] == \
        open(tmp_path / "one.txt").read().split("end of trees")[0]
    assert got.count("Tree=") == 5


# ------------------------------------------------------- gang supervision

_STUB = ("import sys, time\n"
         "rank, attempt, mode = sys.argv[1:4]\n"
         "rank, attempt = int(rank), int(attempt)\n"
         "if mode == 'rank1_dies' and rank == 1 and attempt == 0:\n"
         "    sys.exit(7)\n"
         "if mode == 'rank0_sleeps' and rank == 0:\n"
         "    time.sleep(60)\n"
         "if mode == 'beat_then_hang':\n"
         "    import os\n"
         "    d = sys.argv[4]\n"
         "    open(os.path.join(d, f'hb_{rank}'), 'w').write('0')\n"
         "    time.sleep(60)\n"
         "time.sleep(0.05)\n")


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


def _stub_spawn(mode, gang_dir=""):
    def spawn(world, rank, attempt):
        return subprocess.Popen([sys.executable, "-c", _STUB, str(rank), str(attempt), mode,
                                 gang_dir])
    return spawn


def test_gang_reaps_siblings_on_first_loss():
    seen = []

    def spawn(world, rank, attempt):
        p = _stub_spawn("rank1_dies" if rank == 1 else "rank0_sleeps")(world, rank, attempt)
        seen.append(p)
        return p

    t0 = time.perf_counter()
    rc = GangSupervisor(spawn, 2, poll_s=0.02, reap_grace_s=2.0).run()
    assert rc == 7
    assert time.perf_counter() - t0 < 30.0  # nowhere near rank 0's 60 s
    assert all(p.poll() is not None for p in seen)


def test_gang_elastic_restart_recovers():
    sup = GangSupervisor(_stub_spawn("rank1_dies"), 4, elastic=True, max_restarts=2,
                         poll_s=0.02)
    assert sup.run() == 0
    assert sup.attempts_used == 1
    assert sup.last_recovery_ms is not None and sup.last_recovery_ms > 0


def test_gang_restart_budget_exhausts():
    def spawn(world, rank, attempt):
        return subprocess.Popen([sys.executable, "-c",
                                 "import sys; sys.exit(7 if int(sys.argv[1]) == 1 else 0)",
                                 str(rank)])

    sup = GangSupervisor(spawn, 2, elastic=True, max_restarts=1, poll_s=0.02)
    assert sup.run() == 7
    assert sup.attempts_used == 1


def test_gang_shrink_drops_world_size():
    sup = GangSupervisor(_stub_spawn("rank1_dies"), 4, elastic=True, max_restarts=1,
                         allow_shrink=True, poll_s=0.02)
    assert sup.run() == 0
    assert sup.worlds == [4, 3]


def test_gang_liveness_deadline_reaps_hung_worker(tmp_path):
    gd = str(tmp_path)
    sup = GangSupervisor(_stub_spawn("beat_then_hang", gd), 2, liveness_timeout_s=0.6,
                         gang_dir=gd, poll_s=0.05, reap_grace_s=2.0)
    t0 = time.perf_counter()
    assert sup.run() == 1  # a liveness loss has no exit code: the supervisor's own
    assert time.perf_counter() - t0 < 30.0


def test_worker_env_builds_gang_block():
    env = worker_env({"PATH": "/bin"}, port=12345, world=4, rank=2)
    assert env == {"PATH": "/bin", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "12345",
                   "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"}


def test_latest_snapshot_skips_torn_sidecar(tmp_path):
    X, y = grid_regression(1, n=300, f=4)
    out = str(tmp_path / "model.txt")
    lt.train({"objective": "regression", "num_leaves": 7, "device_type": "cpu",
              "verbosity": -1}, lt.Dataset(X, label=y), num_boost_round=4,
             callbacks=[checkpoint_callback(lambda it: f"{out}.snapshot_iter_{it}",
                                            period=2)])
    assert latest_snapshot(out).endswith(".snapshot_iter_4")
    os.unlink(f"{out}.snapshot_iter_4.ckpt")
    assert latest_snapshot(out).endswith(".snapshot_iter_2")
    assert latest_snapshot(str(tmp_path / "none.txt")) is None


@pytest.mark.parametrize("m", [7, 8])
def test_int16_pair_wire_sums_exactly(m):
    g = torch.Generator().manual_seed(m)
    parts = [torch.randint(-8000, 8000, (5, m), dtype=torch.int32, generator=g)
             for _ in range(4)]
    words = sum(dist.pack_int16_pairs(p) for p in parts)
    assert words.shape == (5, -(-m // 2))
    assert torch.equal(dist.unpack_int16_pairs(words, m), sum(parts))
