"""Command-line application: train / predict / convert_model / refit /
save_binary / serve, driven by reference-format config files.

Counterpart of the JAX package's ``cli.py`` (src/main.cpp and
src/application/application.cpp): the same `key=value` arguments and
`config=train.conf` files as the reference CLI, so the reference's example
configs run unchanged:

    python -m lightgbm_tpu_torch.cli config=train.conf data=binary.train

It runs on the CUDA card unless `device_type=cpu` is given. A distributed
run joins its gang first (parallel/dist.py:init_distributed: the
launcher's environment, or the conf's machine list); every rank runs the
same command, and rank 0 writes the model:

    python -m lightgbm_tpu_torch.launch -n 4 -- config=train.conf tree_learner=data

`telemetry_dir=<dir>` records the run's event stream and trace
(telemetry.py).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from . import callback as callback_mod
from . import checkpoint as checkpoint_mod
from .basic import Booster, Dataset
from .config import Config, key_alias_transform, kv2map, load_config_file
from .engine import train as train_fn
from .io.parser import load_query_boundaries, load_weights, parse_file
from .parallel import dist
from .parallel.mesh import data_world
from .utils.log import Log, set_verbosity


def _parse_args(argv: List[str]) -> Dict[str, str]:
    kvs = kv2map(argv)
    if "config" in kvs:
        for k, v in load_config_file(kvs["config"]).items():
            kvs.setdefault(k, v)
    return kvs


def run(argv: List[str]) -> int:
    params = key_alias_transform(_parse_args(argv))
    task = params.pop("task", "train")
    config = Config(params)
    set_verbosity(config.verbosity)
    dist.init_distributed(config)
    data_world(config.num_machines)  # num_machines > 1 needs a joined gang

    if task == "train":
        return _task_train(config, params)
    if task in ("predict", "prediction", "test"):
        return _task_predict(config, params)
    if task == "convert_model":
        return _task_convert(config)
    if task == "refit":
        return _task_refit(config, params)
    if task == "save_binary":
        Dataset(config.data, params=params).save_binary((config.data or "train") + ".bin")
        return 0
    if task == "serve":
        return _task_serve(config, params)
    Log.fatal("Unknown task type %s", task)
    return 1


def _task_train(config: Config, params: Dict[str, str]) -> int:
    if not config.data:
        Log.fatal("No training data, please set data=... in the config")
    train_ds = Dataset(config.data, params=params)
    if config.save_binary:
        # is_save_binary_file: the constructed dataset's cache beside the
        # text file (application.cpp LoadData -> SaveBinaryFile)
        train_ds.save_binary(str(config.data) + ".bin")
        Log.info("Saved binary dataset cache to %s.bin", config.data)
    valid_paths = config.valid if isinstance(config.valid, list) else (
        [v for v in str(config.valid).split(",") if v])
    valid_sets = [Dataset(vp, reference=train_ds, params=params) for vp in valid_paths]
    valid_names = [f"valid_{i + 1}" for i in range(len(valid_paths))]
    callbacks = [callback_mod.log_evaluation(period=max(config.metric_freq, 1))]
    out = config.output_model or "LightGBM_model.txt"
    world = dist.current_world()
    if config.snapshot_freq > 0 and (world is None or world.rank == 0):
        # gbdt.cpp:258-262's periodic snapshots as full checkpoints: each
        # <out>.snapshot_iter_<k> model file has a .ckpt sidecar, and
        # input_model=<snapshot> resumes bit-identically (in a gang rank 0
        # writes them, as it writes the model)
        callbacks.append(checkpoint_mod.checkpoint_callback(
            lambda it: f"{out}.snapshot_iter_{it}", period=config.snapshot_freq))
    booster = train_fn(params, train_ds, num_boost_round=config.num_iterations,
                       valid_sets=valid_sets or None, valid_names=valid_names or None,
                       init_model=config.input_model or None, callbacks=callbacks)
    if world is None or world.rank == 0:
        booster.save_model(out)
        Log.info("Finished training, model saved to %s", out)
    return 0


def _task_refit(config: Config, params: Dict[str, str]) -> int:
    """Application refit (application.cpp:229-268): the input model's leaf
    indices on the refit data, then RefitTree."""
    if not config.input_model:
        Log.fatal("No input model, please set input_model=...")
    if not config.data:
        Log.fatal("No refit data, please set data=...")
    old = Booster(model_file=config.input_model, params=params)
    X, y, _ = parse_file(config.data, header=config.header,
                         label_column=config.label_column or "0")
    new_booster = old.refit(X, y, decay_rate=config.refit_decay_rate,
                            weight=load_weights(config.data),
                            group=load_query_boundaries(config.data), params=params)
    out = config.output_model or "LightGBM_model.txt"
    new_booster.save_model(out)
    Log.info("Finished RefitTree, model saved to %s", out)
    return 0


def _task_predict(config: Config, params: Dict[str, str]) -> int:
    if not config.input_model:
        Log.fatal("No input model, please set input_model=...")
    booster = Booster(model_file=config.input_model, params=params)
    X, _, _ = parse_file(config.data, header=config.header,
                         label_column=config.label_column or "0")
    pred = booster.predict(
        X, raw_score=config.predict_raw_score, pred_leaf=config.predict_leaf_index,
        pred_contrib=config.predict_contrib,
        num_iteration=config.num_iteration_predict
        if config.num_iteration_predict > 0 else None)
    out = config.output_result or "LightGBM_predict_result.txt"
    np.savetxt(out, np.asarray(pred), fmt="%.9g",
               delimiter="\t" if np.ndim(pred) > 1 else "\n")
    Log.info("Finished prediction, results saved to %s", out)
    return 0


def _task_serve(config: Config, params: Dict[str, str]) -> int:
    """The prediction server (serving/http.py) on the configured device:

        python -m lightgbm_tpu_torch.cli task=serve input_model=model.txt \\
            serve_port=8080 serve_model_name=default

    Serve keys are read from the raw parameters (Config keeps unknown
    keys): serve_host, serve_port, serve_model_name, serve_max_batch_rows,
    serve_max_queue_rows, serve_batch_window_ms, serve_default_timeout_ms,
    serve_hbm_limit_bytes, serve_reject_nonfinite. A model with a .ckpt
    sidecar is verified against it. The breaker sheds an open model's
    requests; nothing is answered on the host."""
    if not config.input_model:
        Log.fatal("No input model, please set input_model=...")
    from .serving import CircuitBreaker, PredictionService
    from .serving.http import serve as serve_http

    timeout_ms = params.get("serve_default_timeout_ms")
    service = PredictionService(
        device=config.device_type,
        max_batch_rows=int(params.get("serve_max_batch_rows", 4096)),
        max_queue_rows=int(params.get("serve_max_queue_rows", 32768)),
        batch_window_s=float(params.get("serve_batch_window_ms", 1.0)) / 1e3,
        default_timeout_s=float(timeout_ms) / 1e3 if timeout_ms is not None else None,
        breaker=CircuitBreaker(hbm_limit_bytes=int(params.get("serve_hbm_limit_bytes", 0))))
    name = params.get("serve_model_name", "default")
    service.load_model(name, path=config.input_model,
                       reject_nonfinite=params.get("serve_reject_nonfinite", "")
                       in ("1", "true", "True"))
    server, thread = serve_http(service, host=params.get("serve_host", "127.0.0.1"),
                                port=int(params.get("serve_port", 8080)))
    Log.info("serving model '%s' from %s; Ctrl-C to stop", name, config.input_model)
    try:
        thread.join()
    except KeyboardInterrupt:
        Log.info("shutting down")
        server.shutdown()
        service.close()
    return 0


def _task_convert(config: Config) -> int:
    from .models.codegen import model_to_cpp
    from .models.serialize import GBDTModel

    if not config.input_model:
        Log.fatal("No input model, please set input_model=...")
    model = GBDTModel.from_file(config.input_model)
    out = config.convert_model or "gbdt_prediction.cpp"
    if config.convert_model_language in ("", "cpp"):
        checkpoint_mod.atomic_write_text(out, model_to_cpp(model))
        Log.info("Model converted to if-else C++ at %s", out)
    elif config.convert_model_language == "json":
        checkpoint_mod.atomic_write_text(out, model.dump_json())
        Log.info("Model converted (JSON form) to %s", out)
    else:
        Log.fatal("Unknown convert_model_language %s", config.convert_model_language)
    return 0


def main() -> None:
    from .parallel.elastic import EXIT_WORKER_LOST, WorkerLostError

    try:
        rc = run(sys.argv[1:])
    except WorkerLostError as exc:
        # the watchdog declared the gang lost: exit with the lost-worker
        # code for the supervisor, leaving the broken process group as it is
        Log.warning("%s; exiting %d", exc, EXIT_WORKER_LOST)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_WORKER_LOST)
    dist.shutdown()  # leave the gang, if one was joined
    sys.exit(rc)


if __name__ == "__main__":
    main()
