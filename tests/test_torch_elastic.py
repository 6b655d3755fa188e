"""The gang's failure handling (lightgbm_tpu_torch/parallel/elastic.py, the
distributed fault tokens of utils/faults.py, the voting learner's exact
check, the shrink-resume contract) on the CPU, after the JAX package's
tests/test_elastic.py and against it through `jax_ref`.

Contracts:
* `slow_worker` fires on every gang attempt, `worker_kill` and
  `worker_hang` on attempt 0 only; outside a gang the kill raises
  InjectedFault; the exit codes are distinct (43 an injected kill, 117 a
  lost worker);
* the watchdog turns `worker_hang@0:2` into WorkerLostError with the rank
  and the last good iteration 2, dumps a `worker_lost` flight postmortem
  (JAX tests/test_elastic.py:250), and disarms at the end of training;
  a worker writes its liveness file `<gang dir>/hb_<rank>`;
* the heartbeat rides the health monitor's window: on a gloo gang of 2
  its count equals the JAX run's (one a window), the self-windowed path
  stays quiet, the model is unchanged, it adds one `item` read a window
  and no other, and with the sanitizer on the collective-order check
  passes at every heartbeat; a short token raises WorkerLostError;
* `vote_skew` under LGBM_TPU_VOTING_EXACT_CHECK raises
  VotingDivergenceError on every rank, with `voting_miss_total` equal to
  the JAX voting learner's, on the 4,096-row layout of
  tests/test_torch_sharded_device.py::test_narrow_vote_matches_jax;
* shrink-resume (JAX tests/test_elastic.py:321): quantized data-parallel
  checkpointed on a gloo gang of 4, resumed on 2, then on 1 process, is
  byte-equal to the undisturbed 4-rank model and to the single-process
  model; the float path on snapped gradients likewise, and byte-equal to
  the JAX package's model (its split search op by op); `launch --elastic
  --allow-shrink` after a `worker_kill` resumes on one rank from rank 0's
  snapshot and writes the undisturbed model;
* the flywheel (JAX tests/test_elastic.py:362): a worker lost mid-refit
  through the real watchdog rolls the generation back, serving keeps the
  last published model, and the next refit publishes.
"""
import json
import os
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import launch
from lightgbm_tpu_torch.parallel import dist, elastic
from lightgbm_tpu_torch.parallel.elastic import EXIT_WORKER_LOST, WorkerLostError
from lightgbm_tpu_torch.utils import faults
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.torch_gang import data, run_gang, snapped_gh

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5}
QUANT = dict(BASE, use_quantized_grad=True, num_grad_quant_bins=4)
CPU = {"device_type": "cpu", "verbosity": -1}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm(monkeypatch, tmp_path):
    from lightgbm_tpu_torch.utils import log

    # cli.run sets the process's log verbosity (verbosity=-1 in its
    # arguments): put it back, so the next file's tests log as by default
    verbosity = log._verbosity
    monkeypatch.setenv("LGBM_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    yield
    faults.clear()
    elastic.clear()
    log.set_verbosity(verbosity)


def _train(params, rounds, n=300):
    X, y = data(1, n=n)
    return lt.train(dict(params, **CPU), lt.Dataset(X, label=y), num_boost_round=rounds)


# ------------------------------------------------------------ the tokens

def test_slow_worker_fires_every_attempt_kill_and_hang_attempt_zero(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_GANG_ATTEMPT", "1")
    monkeypatch.setenv("RANK", "1")
    faults.install("slow_worker@1:200,worker_kill@1:3,worker_hang@1:4")
    t0 = time.perf_counter()
    faults.check_distributed(3)  # a relaunched gang: no kill...
    faults.check_distributed(4)  # ...and no hang, the straggler still sleeps
    assert time.perf_counter() - t0 >= 0.4
    monkeypatch.setenv("LGBM_TPU_GANG_ATTEMPT", "0")
    with pytest.raises(faults.InjectedFault, match="worker 1 killed at iteration 3"):
        faults.check_distributed(3)  # outside a gang: raised, not os._exit
    faults.install("coord_loss@2")
    faults.check_distributed(2)  # rank 1 is not the coordinator


def test_exit_codes_are_distinct():
    assert (faults.EXIT_INJECTED_KILL, EXIT_WORKER_LOST) == (43, 117)
    assert EXIT_WORKER_LOST not in (0, 1, 2)


# ------------------------------------------------- watchdog and heartbeat

def test_watchdog_converts_hang_to_worker_lost(tmp_path):
    """A planted worker_hang blocks the training loop; the watchdog turns
    it into WorkerLostError (rank, last good iteration) within the
    deadline and dumps a flight postmortem."""
    elastic.install(timeout_s=3.0)
    faults.install("worker_hang@0:2")
    t0 = time.perf_counter()
    with pytest.raises(WorkerLostError) as ei:
        _train(BASE, 6)
    assert ei.value.rank == 0 and ei.value.last_good_iteration == 2
    assert time.perf_counter() - t0 < 20.0  # the deadline, not the hang
    flight = tmp_path / "flight"
    dumps = [f for f in os.listdir(flight) if "worker_lost" in f]
    payload = json.loads((flight / dumps[0]).read_text())
    assert payload["extra"]["rank"] == 0
    assert payload["extra"]["last_good_iteration"] == 2


def test_watchdog_error_surfaces_after_its_postmortem(monkeypatch):
    """The watchdog publishes its error only once the flight postmortem is
    written: a checkpoint that raises it (and a reader of the flight
    directory after it) never sees a dump still being written."""
    import threading

    from lightgbm_tpu_torch import tracing

    writing, release = threading.Event(), threading.Event()

    def slow_dump(*args, **kwargs):
        writing.set()
        release.wait(10)

    monkeypatch.setattr(tracing, "dump_flight", slow_dump)
    wd = elastic.CollectiveWatchdog(1.0, rank=0)
    fire = threading.Thread(target=wd._fire, args=((time.monotonic(), 2, 0),))
    fire.start()
    assert writing.wait(10)
    wd.raise_if_expired()  # nothing to raise while the postmortem is written
    assert wd.error is None
    release.set()
    fire.join(10)
    with pytest.raises(WorkerLostError) as ei:
        wd.raise_if_expired()
    assert ei.value.last_good_iteration == 2


def test_watchdog_disarms_at_train_end_and_liveness_file_is_written(tmp_path):
    gang_dir = str(tmp_path / "gang")
    rt = elastic.install(timeout_s=2.0, rank=3, gang_dir=gang_dir)
    _train(BASE, 2)
    assert not rt.watchdog._armed
    time.sleep(2.5)  # past the deadline: the silence is legitimate
    assert rt.watchdog.error is None
    assert open(os.path.join(gang_dir, "hb_3")).read().strip() in ("0", "1")


def test_active_runtime_from_the_gang_environment(monkeypatch, tmp_path):
    assert elastic.active() is None
    env = elastic.worker_env({}, port=1, world=2, rank=1, attempt=2,
                             gang_dir=str(tmp_path), elastic=True)
    for k in ("RANK", "LGBM_TPU_GANG_DIR", "LGBM_TPU_ELASTIC"):
        monkeypatch.setenv(k, env[k])
    monkeypatch.setenv(elastic.ENV_TIMEOUT, "5")
    rt = elastic.active()
    assert rt is elastic.active()  # read once while the environment holds
    assert (rt.rank, rt.gang_dir, rt.watchdog.timeout_s) == (1, str(tmp_path), 5.0)
    assert env["LGBM_TPU_GANG"] == "1" and env["LGBM_TPU_GANG_ATTEMPT"] == "2"


def test_heartbeat_detects_short_token(monkeypatch):
    import torch

    from lightgbm_tpu_torch.parallel.mesh import World

    rt = elastic.install(timeout_s=None, heartbeat_every=1)
    world = World(0, 8, None, torch.device("cpu"), "gloo")
    monkeypatch.setattr(dist, "current_world", lambda: world)
    # a collective that completes short: the gang lost a rank mid-run
    monkeypatch.setattr(dist, "all_reduce", lambda w, t, op="sum": t * 6)
    with pytest.raises(WorkerLostError) as ei:
        rt.heartbeat_sync(iteration=5)
    assert "6/8" in str(ei.value) and ei.value.last_good_iteration == 5


def test_heartbeat_rides_the_health_window_as_jax(jax_ref, tmp_path):
    health = dict(BASE, tree_learner="data", health_check_policy="warn",
                  health_check_every=2)
    out = run_gang("heartbeat_train", 2, tmp_path, health, 4, timeout=60)
    from lightgbm_tpu.parallel import elastic as jax_elastic
    from lightgbm_tpu.utils.timer import global_timer as jax_timer

    X, y = data(0)
    base = int(jax_timer.counters.get("elastic_heartbeats", 0))
    jax_elastic.install(timeout_s=None, heartbeat_every=1)
    try:
        jax_ref.train(dict(BASE, health_check_policy="warn", health_check_every=2, **CPU),
                      jax_ref.Dataset(X, label=y), num_boost_round=4)
    finally:
        jax_elastic.clear()
    want = int(jax_timer.counters.get("elastic_heartbeats", 0)) - base
    assert want == 2  # one a health window: 4 iterations, check_every 2
    for res in out:
        assert res["plain"]["heartbeats"] == want
        assert res["checked"]["order_checks"] == want
        assert res["checked"]["reads"] - res["bare"]["reads"] == want
        assert res["plain"]["model"] == res["bare"]["model"] == out[0]["plain"]["model"]


# ------------------------------------------------------------- vote skew

VOTE = dict(BASE, top_k=2)
SKEW = [(2, "vote_skew@1:1")]


@pytest.mark.parametrize("size,spec", SKEW, ids=[f"ranks{n}-{s}" for n, s in SKEW])
def test_vote_skew_surfaces_with_the_jax_miss_count(jax_ref, monkeypatch, tmp_path, size,
                                                    spec):
    out = run_gang("vote_skew", size, tmp_path, VOTE, spec, 4096, timeout=60)
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.parallel import learners as jl
    from lightgbm_tpu.utils import faults as jax_faults
    from lightgbm_tpu.utils.timer import global_timer as jax_timer

    monkeypatch.setenv("LGBM_TPU_FORCE_MESH_DEVICES", str(size))
    monkeypatch.setenv("LGBM_TPU_VOTING_EXACT_CHECK", "1")
    X, y = data(n=4096)
    cfg = JConfig(dict(VOTE, verbosity=-1))
    learner = jl.VotingDataParallelTreeLearner(cfg, JDataset.from_matrix(X, label=y, config=cfg))
    jax_faults.install(spec)
    jax_timer.reset()
    try:
        with pytest.raises(jax_faults.VotingDivergenceError):
            learner.finalize(learner.train_async(jnp.asarray(snapped_gh(100, 4096)), None))
    finally:
        jax_faults.clear()
    want = int(jax_timer.counters["voting_miss_total"])
    assert want > 0
    for res in out:
        assert res["raised"] is not None and f"({want} committed-split" in res["raised"]
        assert res["miss"] == want


# ---------------------------------------------------------- shrink-resume

ROUNDS = 4  # 2 on 4 ranks, the 3rd on 2, the 4th on one

@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """(quantized?) -> (undisturbed on 4 ranks, the 4 -> 2 -> 1 chain, one
    process undisturbed), float on snapped gradients and quantized."""
    out = {}
    for quantized in (True, False):
        d = tmp_path_factory.mktemp(f"chain{int(quantized)}")
        ck = str(d / "chain.txt")
        params, fobj = (QUANT, False) if quantized else (BASE, True)
        params = dict(params, tree_learner="data")
        four = run_gang("train_legs", 4, d, params, fobj,
                        [(ROUNDS, None, False), (2, ck, False)], timeout=60)
        run_gang("train_legs", 2, d, params, fobj, [(3, ck, True)], timeout=60)
        from tests.torch_gang import train_legs

        one, single = train_legs(params, fobj, [(ROUNDS, ck, True), (ROUNDS, None, False)])
        out[quantized] = (four[0][0], one, single)
    return out


@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "float-snapped"])
def test_shrink_resume_4_2_1_byte_identical(chains, quantized):
    undisturbed, chained, single = chains[quantized]
    assert chained == undisturbed == single


def test_shrink_resume_float_equals_jax(jax_ref, monkeypatch, chains):
    from tests.torch_gang import snapped_logloss

    _op_by_op(monkeypatch)
    X, y = data(0)
    ref = jax_ref.train(dict(BASE, objective=snapped_logloss, **CPU),
                        jax_ref.Dataset(X, label=y), num_boost_round=ROUNDS)
    undisturbed, chained, _ = chains[False]

    def trees(text):
        return text.split("end of trees")[0]
    assert trees(chained) == trees(ref.model_to_string())


def test_launch_elastic_allow_shrink_resumes_on_the_survivors(tmp_path, monkeypatch):
    """worker_kill@1:3 in a 2-rank gang (os._exit(43) under the launcher):
    the supervisor reaps rank 0 and relaunches one rank from rank 0's
    snapshot of iteration 3; the model is the undisturbed one's."""
    from tests.test_torch_launch import _cli_args, _grid_files

    data_file = _grid_files(tmp_path)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("LGBM_TPU_FAULT", "worker_kill@1:3")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "gang.txt")
    args = _cli_args(data_file, out, "tree_learner=data", "snapshot_freq=1", rounds=5)
    assert launch.main(["-n", "2", "--elastic", "--allow-shrink", "--max-restarts", "1",
                        "--gang-dir", str(tmp_path / "gang"), "--", *args]) == 0
    dumps = [f for f in os.listdir(tmp_path / "flight") if "gang_worker_lost" in f]
    lost = json.loads((tmp_path / "flight" / dumps[0]).read_text())["extra"]
    assert (lost["rank"], lost["exit_code"], lost["world_size"]) == (1, 43, 2)
    monkeypatch.delenv("LGBM_TPU_FAULT")
    from lightgbm_tpu_torch import cli

    assert cli.run(_cli_args(data_file, str(tmp_path / "one.txt"), rounds=5)) == 0
    got = open(out).read()
    assert got.split("end of trees")[0] == \
        open(tmp_path / "one.txt").read().split("end of trees")[0]


# --------------------------------------------------------------- flywheel

def test_flywheel_worker_loss_rolls_back_and_keeps_serving(tmp_path):
    from lightgbm_tpu_torch.serving import PredictionService
    from lightgbm_tpu_torch.streaming import ContinuousTrainer, RowBlockStore

    X, y = data(1, n=600)
    params = dict(BASE, **CPU)
    store = RowBlockStore(params=params)
    store.push_rows(X[:400], label=y[:400])
    svc = PredictionService(device="cpu", max_batch_rows=512, batch_window_s=0.0005)
    tr = ContinuousTrainer(params, store, num_boost_round=4, checkpoint_dir=str(tmp_path),
                           service=svc, model_name="live")

    def served():
        return np.asarray(svc.predict("live", X[:32]))

    try:
        _flywheel(tr, store, X, y, served)
    finally:
        svc.close()


def _flywheel(tr, store, X, y, served):
    assert tr.step() is not None and tr.generation == 1
    baseline = served()
    store.push_rows(X[400:], label=y[400:])
    elastic.install(timeout_s=3.0)
    faults.install("worker_hang@0:2")
    assert tr.step() is None  # lost mid-refit through the watchdog: no publish
    faults.clear()
    elastic.clear()
    assert tr.generation == 1 and tr._inflight_rows == 600
    np.testing.assert_array_equal(served(), baseline)  # serving kept answering
    assert tr.step() is not None  # the same pinned rows, resumed
    assert tr.generation == 2 and tr._inflight_rows is None
    assert not np.array_equal(served(), baseline)


def test_row_sharded_wave_learner_snapshot_round_trips():
    """The sharded wave learners keep no whole plane (`bins_dev` None): the
    checkpoint state of DeviceDataParallelTreeLearner names its shard's
    dtype and a resume takes it back (phase 22 of chip_smoke.py found the
    checkpoint raising)."""
    import torch

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
    from lightgbm_tpu_torch.parallel.mesh import data_world
    from lightgbm_tpu_torch.parallel.wave_learners import DeviceDataParallelTreeLearner

    X, y = data(1, n=300)
    cfg = Config(dict(BASE, verbosity=-1))
    ds = CoreDataset.from_matrix(X, label=y, config=cfg)
    cpu = torch.device("cpu")
    learner = DeviceDataParallelTreeLearner(cfg, ds, cpu, data_world(0, cpu))
    assert learner.bins_dev is None
    st = learner.snapshot_state()
    assert st["bins_dtype"] == "torch.uint8" and st["n_devices"] == 1
    learner.restore_snapshot_state(st)
