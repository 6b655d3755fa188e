"""The wave's selection and replay kernels (csrc/wave_step.cu:
wave_select_kernel, wave_select_large_kernel, wave_replay_kernel) against
their plain versions (ops/wave.py) at their edges.

Marked `gpu`: these need an NVIDIA card with nvcc, and skip elsewhere. Run
them on the card with `python -m pytest -m gpu --noconftest
tests/test_torch_cuda_wave_step.py`. Whether a card is present is decided
inside the fixture, never at import.

Contracts: on every state of tests/test_torch_wave_cases.py:WAVE_EDGES
(NaN gains, tied signed zeros, K = 1 and K = L, 1,024 and 1,025 leaves,
4,100 leaves at K = 21 and 1,024, a done tree, the leaf budget binding
mid-wave, max_depth gating a child, a new leaf that is a valid selection)
and on random states of 255 to 4,100 leaves, the kernels' outputs equal the
plain versions' run on the CPU exactly: the selection's table, the commit
table, and the state after the replay (leaf_best, depth, start, count, the
split log's bits, the scalars with the done word); a second launch gives
the same bits, and each launch is counted.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import wave_cuda
from lightgbm_tpu_torch.ops.wave import (DONE, FeatureTables, _replay_wave_plain,
                                         _select_wave_plain, split_select)
from test_torch_wave_cases import (WAVE_EDGES, wave_children, wave_edge, wave_state,
                                   wave_tables_random)

pytestmark = pytest.mark.gpu
STATE = ("leaf_best", "depth", "rec_store", "start", "count", "scalars")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _kernels_equal_plain(cuda, st, tables, K, recs2, totals2, nl, params, max_depth):
    """The selection then the replay, twice on the card and once by the
    plain versions on the CPU, every output compared byte for byte.
    Returns the commits."""
    tabs = [torch.from_numpy(np.asarray(a)) for a in tables]
    runs = []
    for device in (cuda, cuda, "cpu"):
        s = {k: torch.from_numpy(st[k].copy()).to(device) for k in STATE}
        ft = FeatureTables(*(t.to(device) for t in tabs))
        before = {k: wave_cuda.launches[k] for k in ("wave_select", "wave_replay")}
        sel_args = (s["leaf_best"], s["start"], s["count"], s["scalars"], ft, K)
        table = (wave_cuda.select(*sel_args) if device != "cpu"
                 else _select_wave_plain(*sel_args))
        table_in = table.clone()
        rp_args = (s["leaf_best"], s["depth"], s["rec_store"], s["start"], s["count"],
                   s["scalars"], table, torch.from_numpy(nl).to(device),
                   torch.from_numpy(recs2).to(device), torch.from_numpy(totals2).to(device),
                   torch.from_numpy(params).to(device), max_depth)
        commit = (wave_cuda.replay(*rp_args) if device != "cpu"
                  else _replay_wave_plain(*rp_args))
        if device != "cpu":
            torch.cuda.synchronize()
        grew = {k: wave_cuda.launches[k] - before[k] for k in before}
        assert grew == ({"wave_select": 1, "wave_replay": 1} if device != "cpu"
                        else {"wave_select": 0, "wave_replay": 0})
        runs.append([table_in.cpu(), commit.cpu()] + [s[k].cpu() for k in STATE])
    names = ("table", "commit") + STATE
    for got in runs[:2]:
        for name, g, r in zip(names, got, runs[2]):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            assert torch.equal(g.view(torch.uint8), r.view(torch.uint8)), name
    return int(runs[2][7][1] - int(st["scalars"][1]))


@pytest.mark.parametrize("name", [e[0] for e in WAVE_EDGES])
def test_edge_states_match_plain(cuda, name):
    e = wave_edge(name)
    n = _kernels_equal_plain(cuda, e["state"], e["tables"], e["K"], e["recs2"], e["totals2"],
                             e["n_left"], e["params"], e["max_depth"])
    assert n == 0 if name in ("nan_gains", "done") else n > 0


@pytest.mark.parametrize("L,K", [(255, 21), (255, 1), (1024, 21), (1025, 64), (4100, 21)])
@pytest.mark.parametrize("seed", range(3))
def test_random_states_match_plain(cuda, L, K, seed):
    """Random live states with NaN and signed-zero gains sprinkled among
    the leaves (all but the first seed, so that one replays long)."""
    rng = np.random.RandomState(seed * 7919 + L + K)
    n_cur = int(rng.randint(max(2, K), L // 2 + 2))
    st = wave_state(rng, L, n_cur)
    if seed:
        g = st["leaf_best"][:, 0]
        g[rng.randint(0, n_cur, 3)] = rng.choice([0.0, -0.0, np.nan], 3)
    tables = wave_tables_random(rng, 6)
    table = _select_wave_plain(*(torch.from_numpy(st[k].copy()) for k in
                                 ("leaf_best", "start", "count", "scalars")),
                               FeatureTables(*(torch.from_numpy(a) for a in tables)), K)
    parts = split_select(table, L, K)
    recs2, totals2, nl = wave_children(rng, st, parts[5].numpy(), parts[4].numpy() != 0)
    params = np.array([0.25, 0.5, 5.0, 1e-3, 0.0, 0.0], np.float32)
    st["scalars"][DONE] = 0
    _kernels_equal_plain(cuda, st, tables, K, recs2, totals2, nl, params,
                         int(rng.randint(-1, 8)))
