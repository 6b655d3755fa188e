"""A gang of gloo ranks on the CPU for the distributed learners' tests, and
the jobs its ranks run. It imports nothing of the JAX package, so the
card's tests use it too.

`run_gang(job, size, tmp_path, *args)` starts `size` processes with
``torch.multiprocessing`` (spawn), joined through a FileStore under
`tmp_path`; rank r runs `JOBS[job](*args)` with one or two intra-op threads
and its result (picklable, no tensors) comes back in rank order.
"""
import os
import pickle
import sys
import traceback

import numpy as np
import torch

N_ROWS, N_FEATURES = 1200, 7


def snapped_logloss(preds, dataset):
    """Binary logloss gradients on a 2**-4 grid: every sum of them is exact
    in float32 in any order (tests/test_torch_train.py's)."""
    p = 1.0 / (1.0 + np.exp(-preds))
    label = dataset.get_label()
    grad = np.round((p - label) * 16) / 16
    hess = np.round(np.maximum(p * (1.0 - p), 1.0 / 16) * 16) / 16
    return grad, hess


def data(seed=0, n=N_ROWS, f=N_FEATURES, categorical=False):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    if categorical:
        X[:, 0] = rng.randint(0, 12, size=n)
        y = ((X[:, 0] % 3 == 0) ^ (X[:, 1] > 0.3)).astype(float)
    else:
        y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(float)
    return X, y


def snapped_gh(seed, n=N_ROWS, snapped=True):
    """[n + 1, 3] (grad, hess, 1) with the zero sentinel row, snapped to a
    2**-10 grid (or, with snapped False, the raw draws)."""
    rng = np.random.RandomState(seed)
    g = rng.uniform(-1.0, 1.0, n)
    h = rng.uniform(0.25, 1.0, n)
    if snapped:
        g, h = np.round(g * 1024) / 1024, np.round(h * 1024) / 1024
    gh = np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)
    return np.concatenate([gh, np.zeros((1, 3), np.float32)])


# --------------------------------------------------------------- the jobs

def train_models(configs, rounds, seed=0):
    """lt.train on the CPU for each (params, snapped fobj?, categorical?)
    config; returns each model text, the learner's class and the final
    train score (the factory picks the learner: on the CPU the host-driven
    one for data / feature / voting)."""
    import lightgbm_tpu_torch as lt

    out = []
    for params, fobj, categorical in configs:
        X, y = data(seed, categorical=categorical)
        p = dict(params, device_type="cpu", verbosity=-1)
        if fobj:
            p["objective"] = snapped_logloss
        ds = lt.Dataset(X, label=y, categorical_feature=[0] if categorical else "auto")
        bst = lt.train(p, ds, num_boost_round=rounds)
        out.append({"model": bst.model_to_string(),
                    "learner": type(bst._gbdt.tree_learner).__name__,
                    "score": bst._gbdt.score[0].numpy().copy()})
    return out


def grow_trees(cls_name, params, n_trees=2, bag=None, wave=21, n_rows=N_ROWS,
               device="cpu", snapped=True):
    """`n_trees` trees of the named learner (the sharded wave learners by
    their class) on snapped (or raw) gradients: each tree's text, leaf ids
    and the timer's counters (the wire's gauges)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
    from lightgbm_tpu_torch.parallel import dist, learners, wave_learners
    from lightgbm_tpu_torch.parallel.mesh import data_world
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
    from lightgbm_tpu_torch.treelearner.serial import SerialTreeLearner
    from lightgbm_tpu_torch.utils.timer import global_timer

    X, y = data(n=n_rows)
    cfg = Config(dict(params, verbosity=-1))
    ds = CoreDataset.from_matrix(X, label=y, config=cfg)
    cpu = torch.device(device)
    world = dist.current_world() or data_world(0, cpu)
    if cls_name == "SerialTreeLearner":
        learner = SerialTreeLearner(cfg, ds, cpu)
    elif cls_name == "DeviceTreeLearner":
        learner = DeviceTreeLearner(cfg, ds, cpu, wave=wave)
    elif hasattr(wave_learners, cls_name):
        learner = getattr(wave_learners, cls_name)(cfg, ds, cpu, world, wave=wave)
    else:
        learner = getattr(learners, cls_name)(cfg, ds, cpu, world)
    if hasattr(learner, "_adaptive_wave"):
        learner._adaptive_wave = False
    out = []
    global_timer.reset()
    for t in range(n_trees):
        gh = torch.from_numpy(snapped_gh(100 + t, n_rows, snapped)).to(cpu)
        tree = learner.train(gh, None if bag is None else np.asarray(bag, np.int32))
        ids = learner.partition.leaf_ids_dev() if hasattr(learner.partition, "leaf_ids_dev") \
            else None
        out.append({"tree": tree.to_string(),
                    "ids": None if ids is None else ids.cpu().numpy().copy(),
                    "counters": {k: int(v) for k, v in global_timer.counters.items()}})
    return out


def predict_sharded(model_text, n_rows, shard_rows):
    """Booster.predict of `n_rows` rows whole and row-sharded, and a
    service loaded with shard_rows: the three results and the rows this
    rank traversed."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.serving import PredictionService
    from lightgbm_tpu_torch.utils.timer import global_timer

    rng = np.random.RandomState(5)
    X = rng.normal(size=(n_rows, N_FEATURES)).astype(np.float32)
    bst = lt.Booster(model_str=model_text, params={"device_type": "cpu"})
    whole = bst.predict(X, pred_shard_rows=n_rows + 1)  # the reference: every row here
    global_timer.reset()
    sharded = bst.predict(X, pred_shard_rows=shard_rows)
    rows = int(global_timer.counters.get("predict_sharded_rows", 0))
    # batches of 2,048 rows: above shard_rows, so each one is split
    svc = PredictionService(device="cpu", max_batch_rows=2048, max_queue_rows=8192,
                            max_request_rows=4096)
    try:
        svc.load_model("m", booster=bst, shard_rows=shard_rows)
        served = np.asarray(svc.predict("m", X[:1024]))
    finally:
        svc.close()
    return {"whole": whole, "sharded": sharded, "served": served, "rows": rows,
            "served_rows": int(global_timer.counters.get("predict_sharded_rows", 0)) - rows}


def cli_train(args):
    """The CLI in the gang (rank 0 writes the model)."""
    from lightgbm_tpu_torch import cli

    return cli.run(list(args))


def grow_many(jobs):
    """grow_trees for each (cls_name, params, kwargs) in one gang."""
    return [grow_trees(cls_name, params, **kw) for cls_name, params, kw in jobs]


def vote_skew(params, spec, n_rows):
    """One voting tree under the exact check with the fault `spec` armed:
    the VotingDivergenceError's message (None when nothing was raised) and
    the voting_miss_total counter."""
    from lightgbm_tpu_torch.utils import faults
    from lightgbm_tpu_torch.utils.timer import global_timer

    os.environ["LGBM_TPU_VOTING_EXACT_CHECK"] = "1"
    faults.install(spec)
    raised = None
    try:
        grow_trees("VotingDataParallelTreeLearner", params, n_trees=1, n_rows=n_rows)
    except faults.VotingDivergenceError as exc:
        raised = str(exc)
    finally:
        faults.clear()
        del os.environ["LGBM_TPU_VOTING_EXACT_CHECK"]
    return {"raised": raised, "miss": int(global_timer.counters.get("voting_miss_total", 0))}


def stream_models(configs, env, rounds, device="cpu"):
    """lt.train on `device` under the streaming environment `env` (the
    budget, the block rows) for each (params, snapped fobj?, rows) config:
    the model text, the learner's class, the blocks this rank uploaded and
    the timer's counters."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.utils.timer import global_timer

    os.environ.update(env)
    out = []
    for params, fobj, n_rows in configs:
        X, y = data(3, n=n_rows, f=12)
        p = dict(params, device_type=device, verbosity=-1)
        if fobj:
            p["objective"] = snapped_logloss
        global_timer.reset()
        bst = lt.train(p, lt.Dataset(X, label=y), num_boost_round=rounds)
        learner = bst._gbdt.tree_learner
        out.append({"model": bst.model_to_string(), "learner": type(learner).__name__,
                    "uploaded": sorted(learner._cache.uploaded),
                    "groups": len(learner.dataset.groups), "bins": learner.group_bin_padded,
                    "counters": {k: int(v) for k, v in global_timer.counters.items()}})
    return out


def sharded_fit(n_rows, chunk, bin_sample_rows):
    """A ShardedRowBlockStore over the gang (the layout fit through the
    all-gather of the shards' payloads) beside the raw-prefix RowBlockStore
    on the same pushes: whether the cut points, the EFB groups and the
    planes agree, and the shard count."""
    from lightgbm_tpu_torch.streaming import RowBlockStore, ShardedRowBlockStore

    rng = np.random.RandomState(11)
    X = rng.standard_normal((n_rows, 8))
    X[X < -1.2] = 0.0
    X[rng.rand(n_rows, 8) < 0.01] = np.nan
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float64)
    params = {"objective": "binary", "verbosity": -1, "device_type": "cpu"}
    stores = [RowBlockStore(params=params, bin_sample_rows=bin_sample_rows),
              ShardedRowBlockStore(params=params, bin_sample_rows=bin_sample_rows)]
    for store in stores:
        for lo in range(0, n_rows, chunk):
            store.push_rows(X[lo:lo + chunk], label=y[lo:lo + chunk])
    base, sh = stores
    cuts = all(np.array_equal(np.asarray(a.bin_upper_bound, float),
                              np.asarray(b.bin_upper_bound, float), equal_nan=True)
               for a, b in zip(base._layout.mappers, sh._layout.mappers))
    return {"cuts": cuts, "groups": sh._group_lists == base._group_lists,
            "plane": bool(np.array_equal(base.finalize().bins, sh.finalize().bins)),
            "shards": sh.num_shards}


def sharded_stream(configs, env, rounds, fit):
    """stream_models and sharded_fit in one gang."""
    return {"models": stream_models(configs, env, rounds), "fit": sharded_fit(*fit)}


def card_stream(configs, env, rounds):
    """stream_models on the card."""
    return stream_models(configs, env, rounds, device="cuda")


def heartbeat_train(params, rounds):
    """tree_learner=data on the CPU three times: with an elastic runtime
    (heartbeat_every 1: only the health window may carry it), with it and
    the sanitizer on, and with the sanitizer alone. The heartbeats and the
    model of the first; the collective-order checks of the second; the CPU
    tensors' `item` reads of the second and third."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.parallel import elastic
    from lightgbm_tpu_torch.utils import sanitize
    from lightgbm_tpu_torch.utils.timer import global_timer

    X, y = data(0)
    out = {}
    for tag, runtime, sanitized in (("plain", True, False), ("checked", True, True),
                                    ("bare", False, True)):
        global_timer.reset()
        if runtime:
            elastic.install(timeout_s=None, heartbeat_every=1)
        if sanitized:
            sanitize.enable("cpu")
            sanitize.reset()
        try:
            bst = lt.train(dict(params, device_type="cpu", verbosity=-1),
                           lt.Dataset(X, label=y), num_boost_round=rounds)
            reads = sum(k.get("item", 0) for k in sanitize.sync_counts().values())
        finally:
            sanitize.disable()
            sanitize.clear_override()
            elastic.clear()
        c = global_timer.counters
        out[tag] = {"heartbeats": int(c.get("elastic_heartbeats", 0)),
                    "order_checks": int(c.get("collective_order_checks", 0)),
                    "reads": reads, "model": bst.model_to_string()}
    return out


def collective_order():
    """Every dist collective recorded while the sanitizer is on, then a
    planted divergence: rank 0 all-reduces where rank 1 reduce-scatters
    (on gloo one all-reduce either way, so nothing blocks), and the check
    on each rank: the sequence, the window after the agreeing check closed
    it, and (the raiser, the op the check named, the message)."""
    from lightgbm_tpu_torch.parallel import dist
    from lightgbm_tpu_torch.utils import sanitize

    world = dist.current_world()
    sanitize.enable("cpu")
    sanitize.reset()
    try:
        t = torch.ones(4)
        dist.all_reduce(world, t)
        dist.reduce_scatter(world, t)
        dist.all_gather(world, t)
        lo, hi = world.row_range(5)
        dist.all_gather_rows(world, torch.ones(hi - lo), 5)
        seq = sanitize.collective_sequence()
        sanitize.check_collective_order()  # every rank agrees: quiet
        (dist.all_reduce if world.rank == 0 else dist.reduce_scatter)(world, t)
        window = sanitize.collective_sequence()
        try:
            sanitize.check_collective_order()
            caught = None
        except sanitize.CollectiveOrderError as exc:
            caught = (exc.rank, exc.first_divergent_op, str(exc))
    finally:
        sanitize.disable()
        sanitize.clear_override()
    return {"seq": seq, "window": window, "caught": caught}


def train_legs(params, fobj, legs):
    """Data-parallel training on the CPU, quantized or on snapped-fobj
    float gradients, once a (total rounds, checkpoint, resume) leg: rank 0
    writes the checkpoint every iteration, a resuming leg starts from it.
    Each leg's model text."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.checkpoint import checkpoint_callback
    from lightgbm_tpu_torch.parallel import dist

    X, y = data(0)
    world = dist.current_world()
    p = dict(params, device_type="cpu", verbosity=-1)
    if fobj:
        p["objective"] = snapped_logloss
    out = []
    for total, ck, resume in legs:
        cbs = ([checkpoint_callback(ck, period=1)]
               if ck is not None and (world is None or world.rank == 0) else None)
        bst = lt.train(dict(p), lt.Dataset(X, label=y), num_boost_round=total,
                       init_model=ck if resume else None, callbacks=cbs)
        out.append(bst.model_to_string())
    return out


def flywheel_shrink(params, env, ckdir, store_dir, survivors, timeout_s):
    """The gang-sharded flywheel on the CPU: an undisturbed refit; then a
    refit in which every rank's watchdog turns a planted hang at iteration
    2 into WorkerLostError (the generation rolls back, the watermark stays
    pinned); then the gang shrinks to `survivors` ranks in place (a new
    process group) and the same trainer resumes the refit: its model text
    beside the undisturbed one's, and what the rollback left."""
    from lightgbm_tpu_torch.parallel import dist, elastic
    from lightgbm_tpu_torch.streaming import ContinuousTrainer, ShardedRowBlockStore
    from lightgbm_tpu_torch.utils import faults

    os.environ.update(env)
    world = dist.current_world()
    rank = world.rank
    X, y = data(42, n=1200, f=10)
    p = dict(params, device_type="cpu", verbosity=-1)

    def filled():
        store = ShardedRowBlockStore(params=p)
        for lo in range(0, 1200, 300):
            store.push_rows(X[lo:lo + 300], label=y[lo:lo + 300])
        return store

    straight = ContinuousTrainer(p, filled(), num_boost_round=4,
                                 checkpoint_dir=os.path.join(ckdir, f"clean{rank}")).step()
    store = filled()
    shards = store.num_shards
    tr = ContinuousTrainer(p, store, num_boost_round=4,
                           checkpoint_dir=os.path.join(ckdir, f"crashy{rank}"))
    elastic.install(timeout_s=timeout_s, rank=rank)
    faults.install(f"worker_hang@{rank}:2")
    os.environ["RANK"] = str(rank)
    try:
        lost = tr.step()
    finally:
        faults.clear()
        elastic.clear()
        del os.environ["RANK"]
    out = {"lost": lost is None, "generation": tr.generation, "inflight": tr._inflight_rows,
           "shards_before": shards, "straight": straight.model_to_string()}
    dist.shutdown()
    if rank >= survivors:
        return out
    torch.distributed.init_process_group("gloo", init_method=f"file://{store_dir}",
                                         rank=rank, world_size=survivors)
    resumed = tr.step()
    out.update(resumed=resumed.model_to_string(), generation_after=tr.generation,
               shards_after=store.num_shards)
    return out


# -------------------------------------------------------------- the gang

def join_machine_list(mlist, port):
    """init_distributed from a machine-list conf (this rank given
    explicitly: every line of a one-host list names this host), then one
    all-reduce: (size, rank, backend, the ranks' sum)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel import dist

    cfg = Config({"machine_list_filename": mlist, "local_listen_port": port,
                  "device_type": "cpu"})
    joined = dist.init_distributed(cfg, rank=int(os.environ["TORCH_GANG_RANK"]))
    world = dist.current_world()
    total = dist.all_reduce(world, torch.tensor([world.rank + 1]))
    dist.shutdown()
    return joined, world.size, world.rank, world.backend, int(total.item())


def _rank(rank, size, store, job, args, out_dir, threads, join):
    torch.set_num_threads(threads)
    os.environ["TORCH_GANG_RANK"] = str(rank)
    try:
        if join:
            torch.distributed.init_process_group(
                "gloo", init_method=f"file://{store}", rank=rank, world_size=size)
        result = JOBS[job](*args)
        if join and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    except BaseException:  # the parent reports the rank's failure
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


JOBS = {"train_models": train_models, "grow_trees": grow_trees, "grow_many": grow_many,
        "predict_sharded": predict_sharded, "cli_train": cli_train,
        "join_machine_list": join_machine_list, "vote_skew": vote_skew,
        "sharded_stream": sharded_stream, "card_stream": card_stream,
        "heartbeat_train": heartbeat_train,
        "collective_order": collective_order, "train_legs": train_legs,
        "flywheel_shrink": flywheel_shrink}


def run_gang(job, size, tmp_path, *args, threads=1, timeout=240, join=True):
    """Each rank's result of JOBS[job](*args), in rank order, from a gang of
    `size` gloo processes (joined here unless `join` is False: the job joins
    itself); a rank's exception fails the caller."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(str(tmp_path), f"gang_{job}_{size}_{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, size, store, job, args, out_dir, threads,
                                             join))
             for r in range(size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(size):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"gang rank {r} of {size} left no result "
                               f"(exit code {procs[r].exitcode})")
        with open(path, "rb") as fh:
            res = pickle.load(fh)
        if isinstance(res, dict) and "error" in res:
            raise RuntimeError(f"gang rank {r} of {size} failed:\n{res['error']}")
        results.append(res)
    return results


if __name__ == "__main__":  # pragma: no cover - a manual check
    print(run_gang("grow_trees", int(sys.argv[1]) if len(sys.argv) > 1 else 2, "/tmp",
                   "DataParallelTreeLearner", {"objective": "binary", "num_leaves": 7}))
