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
        if join:
            torch.distributed.destroy_process_group()
    except BaseException:  # the parent reports the rank's failure
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


JOBS = {"train_models": train_models, "grow_trees": grow_trees, "grow_many": grow_many,
        "predict_sharded": predict_sharded, "cli_train": cli_train,
        "join_machine_list": join_machine_list}


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
