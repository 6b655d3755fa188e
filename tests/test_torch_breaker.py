"""The port's circuit breaker (serving/breaker.py) against the JAX
package's `CircuitBreaker`, on the CPU.

Contract: on the same scripted sequence under the same injected clock —
dispatch failures and successes, cooldowns and probes, compile churn and
memory-pressure signals, entries registered and forgotten — every state,
every `Decision` (shed, chunk cap, probe), the transition count and
the `serve_breaker_state` gauge are EQUAL to the JAX package's after each
step. The port's `Decision.shed` is the JAX `use_host` (OPEN: the port
sheds what the JAX package answers on the host), and a JAX host success
(`on_success(was_host=True)`, a no-op there) has no port counterpart: the
port serves nothing on the host.
"""
import numpy as np
import pytest

from lightgbm_tpu_torch.serving.breaker import (CLOSED, DEGRADED, HALF_OPEN, OPEN,
                                                CircuitBreaker)
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_ref import jax_ref  # noqa: F401

KW = dict(fail_threshold=3, recovery_successes=4, probe_successes=2, cooldown_s=1.0,
          degraded_rows=128, compile_churn_limit=5, hbm_limit_bytes=1000)


def _script(seed):
    """A random sequence of breaker calls over three entries and the
    default shard, with the clock moving."""
    rng = np.random.RandomState(seed)
    entries = ["", "a", "b", "c"]
    steps = []
    compiles = 0
    for _ in range(400):
        r = rng.rand()
        entry = entries[rng.randint(len(entries))]
        if r < 0.30:
            steps.append(("decide", entry))
        elif r < 0.55:
            steps.append(("success", entry, bool(rng.rand() < 0.1)))
        elif r < 0.75:
            steps.append(("failure", entry))
        elif r < 0.85:
            compiles += int(rng.choice([0, 1, 6]))
            steps.append(("signals", {"compiles": compiles,
                                      "hbm_high_water_bytes": int(rng.choice([10, 2000]))}))
        elif r < 0.88:
            steps.append(("rebaseline", {"compiles": compiles}))
        elif r < 0.92:
            steps.append(("register", entry))
        elif r < 0.94:
            steps.append(("forget", entry))
        steps.append(("tick", float(rng.choice([0.0, 0.1, 0.6, 1.2]))))
    return steps


def _run(cls, timer, steps):
    clock = [0.0]
    b = cls(clock=lambda: clock[0], **KW)
    port = cls is CircuitBreaker
    trail = []
    for step in steps:
        kind = step[0]
        out = None
        if kind == "decide":
            d = b.decide(step[1])
            out = (d.shed if port else d.use_host, d.max_rows, d.probe)
        elif kind == "success":
            if port:
                if not step[2]:
                    b.on_success(entry=step[1])
            else:
                b.on_success(was_host=step[2], entry=step[1])
        elif kind == "failure":
            b.on_failure(RuntimeError("unit"), entry=step[1])
        elif kind == "signals":
            b.note_signals(step[1])
        elif kind == "rebaseline":
            b.rebaseline(step[1])
        elif kind == "register":
            b.register_entry(step[1])
        elif kind == "forget":
            b.forget_entry(step[1])
        else:
            clock[0] += step[1]
            continue
        info = b.info()
        shards = {e: v["state"] for e, v in info.get("entries", {}).items()}
        trail.append((kind, out, b.state, info["transitions"], shards,
                      timer.counters["serve_breaker_state"]))
    return trail


@pytest.mark.parametrize("seed", range(4))
def test_scripted_sequence_equals_jax(jax_ref, seed):
    from lightgbm_tpu.serving.breaker import CircuitBreaker as JaxBreaker
    from lightgbm_tpu.utils.timer import global_timer as jax_timer

    steps = _script(seed)
    ours = _run(CircuitBreaker, global_timer, steps)
    theirs = _run(JaxBreaker, jax_timer, steps)
    assert ours == theirs
    states = {t[2] for t in ours}
    assert {CLOSED, OPEN} <= states


def test_trips_probes_and_recovers():
    clock = [0.0]
    b = CircuitBreaker(fail_threshold=2, probe_successes=1, cooldown_s=0.5,
                       clock=lambda: clock[0])
    assert not b.decide("m").shed
    b.on_failure(RuntimeError("x"), entry="m")
    b.on_failure(RuntimeError("y"), entry="m")
    assert b.state == OPEN and b.decide("m").shed
    assert global_timer.counters["serve_breaker_state"] == 2
    assert not b.decide("other").shed  # sharded: another entry stays on the device
    clock[0] = 0.6
    d = b.decide("m")
    assert (d.shed, d.probe) == (False, True) and b.state == HALF_OPEN
    b.on_success(entry="m")
    assert b.state == CLOSED and b.info()["transitions"] == 3
    assert [t["new"] for t in b.info()["last_transitions"]] == [OPEN, HALF_OPEN, CLOSED]


def test_signals_degrade_and_recover():
    b = CircuitBreaker(compile_churn_limit=4, recovery_successes=2)
    b.note_signals({"compiles": 10})
    assert b.state == CLOSED
    b.note_signals({"compiles": 20})
    assert b.state == DEGRADED and b.decide().max_rows == b.degraded_rows
    b.on_success()
    b.on_success()
    assert b.state == CLOSED
    b = CircuitBreaker(hbm_limit_bytes=1000)
    b.note_signals({"compiles": 0, "hbm_high_water_bytes": 2000})
    assert b.state == DEGRADED
