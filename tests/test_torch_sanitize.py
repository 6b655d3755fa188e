"""The port's sync sanitizer (utils/sanitize.py) on the CPU.

Contracts: host reads of tensors on the tracked device type are counted by
the reading thread's innermost timer scope; a read inside a `SYNC_FREE`
scope raises `SyncInScopeError`; disabling restores torch.Tensor's methods
and the timer's hooks; a training run under the sanitizer (tracking the
card, so on the CPU nothing counts) is byte-equal to the run without it;
the process-wide ``torch.cuda.set_sync_debug_mode("error")`` is armed in a
sync-free scope only on explicit request (``enable(..., sync_debug=True)``,
never by the env var) and restored on exit. On the card an implicit sync in
an armed scope raises (the `gpu` test).
"""
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.utils import sanitize
from lightgbm_tpu_torch.utils.timer import global_timer


@pytest.fixture(autouse=True)
def _restore():
    originals = {n: getattr(torch.Tensor, n) for n in sanitize._READS + sanitize._COPIES}
    yield
    sanitize.disable()
    sanitize.clear_override()
    sanitize.reset()
    for n, fn in originals.items():
        assert getattr(torch.Tensor, n) is fn


def test_counts_reads_by_innermost_scope():
    sanitize.enable("cpu")
    t = torch.tensor([1.5, 2.0])
    with global_timer.scope("outer"):
        t[0].item()
        with global_timer.scope("inner"):
            t.tolist()
            bool(t[0] > 0)
            float(t[0])
            int(t[1])
    t.sum().item()
    assert sanitize.sync_counts() == {
        "outer": {"item": 1},
        "inner": {"tolist": 1, "__bool__": 1, "__float__": 1, "__int__": 1},
        "<no-scope>": {"item": 1}}


def test_sync_free_scope_raises_and_names_it():
    sanitize.enable("cpu")
    t = torch.ones(3)
    for scope in sorted(sanitize.SYNC_FREE):
        with pytest.raises(sanitize.SyncInScopeError, match=scope):
            with global_timer.scope(scope):
                with global_timer.scope("nested"):
                    t.sum().item()
    # the stack unwound with the error: a read after it counts outside
    t.sum().item()
    assert sanitize.sync_counts()["<no-scope>"] == {"item": 1}


def test_untracked_device_and_disabled_count_nothing():
    sanitize.enable("cuda")  # CPU tensors are not the card's
    with global_timer.scope("tree_device"):
        torch.ones(2).sum().item()
        torch.ones(2).cpu()
    assert sanitize.sync_counts() == {}
    sanitize.disable()
    assert not global_timer.scope_hooks
    with global_timer.scope("tree_device"):
        torch.ones(2).sum().item()
    assert sanitize.sync_counts() == {}


def test_scope_stacks_are_per_thread():
    sanitize.enable("cpu")
    t = torch.ones(1)
    ready, done = threading.Event(), threading.Event()

    def serving():
        ready.wait()
        with global_timer.scope("serve_batch"):
            t.item()  # another thread's sync-free scope does not apply here
        done.set()

    th = threading.Thread(target=serving)
    th.start()
    with global_timer.scope("tree_device"):
        ready.set()
        done.wait(10)
    th.join()
    assert sanitize.sync_counts() == {"serve_batch": {"item": 1}}


def test_env_var_enables(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_SANITIZE", "1")
    sanitize.clear_override()
    assert sanitize.enabled() and global_timer.scope_hooks
    monkeypatch.setenv("LGBM_TPU_SANITIZE", "0")
    sanitize.clear_override()
    assert not sanitize.enabled() and not global_timer.scope_hooks


def test_training_under_the_sanitizer_is_byte_equal():
    rng = np.random.RandomState(2)
    X = rng.normal(size=(500, 6))
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "device_type": "cpu",
              "verbosity": -1, "data_sample_strategy": "goss", "learning_rate": 0.5}
    off = lt.train(params, lt.Dataset(X, label=y), 4).model_to_string()
    sanitize.enable()
    on = lt.train(params, lt.Dataset(X, label=y), 4).model_to_string()
    assert on == off and sanitize.sync_counts() == {}


def test_sync_debug_mode_is_armed_only_on_request(monkeypatch):
    """The process-wide sync debug mode is armed in a sync-free scope only
    after enable(..., sync_debug=True), never by the env var, and is
    restored when the scope exits."""
    calls = []
    mode = ["default"]

    def set_mode(m):
        calls.append(m)
        mode[0] = m

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setenv("LGBM_TPU_SANITIZE", "1")
    sanitize.clear_override()
    for enable in (lambda: None, lambda: sanitize.enable("cuda")):
        enable()
        assert sanitize.enabled()
        with global_timer.scope("tree_device"):
            pass
        assert calls == []
    sanitize.enable("cuda", sync_debug=True)
    with global_timer.scope("tree_device"):
        with global_timer.scope("hist_root"):
            assert mode == ["error"]
    assert calls == ["error", "default"] and mode == ["default"]
    with global_timer.scope("hist_root"):
        pass
    assert calls == ["error", "default"]
    sanitize.disable()
    sanitize.clear_override()
    with global_timer.scope("tree_device"):
        pass
    assert calls == ["error", "default"]


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_sync_free_scope_arms_sync_debug_mode_on_the_card():
    sanitize.enable("cuda", sync_debug=True)
    x = torch.arange(8, device="cuda")
    before = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError):
        with global_timer.scope("tree_device"):
            torch.nonzero(x > 3)  # an implicit sync no patched method sees
    assert torch.cuda.get_sync_debug_mode() == before
    with global_timer.scope("tree_device"):
        y = x * 2  # no sync: allowed
    assert torch.cuda.get_sync_debug_mode() == before
    with global_timer.scope("hist_root"):
        y.sum().item()
    assert sanitize.sync_counts() == {"hist_root": {"item": 1}}
