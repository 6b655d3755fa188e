"""The wave's selection and replay kernels (csrc/wave_step.cu:
wave_select_kernel, wave_select_large_kernel, wave_replay_kernel) against
their plain versions (ops/wave.py) at their edges, and the tree graph's
loop (lgbt_tree_graph: the second wave's replay sets the WHILE node's
condition) against the loop driven from the host.

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
the same bits, and each launch is counted. A tree grown by its tree graph
and the same tree grown by `_waves_eager` (the host reading the done word
each pass) from the same staged inputs give the same split log, scalars,
passes and leaf ids: unbagged and bagged, with and without a feature mask,
K = 1 and 21, L = 2, 3 and 255, and a stump done at its root (no pass);
the graphed tree launches the condition kernel once, whatever its passes.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset
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


def _tree_case(device, K, bagged, masked, L, stump, n=20000):
    """A learner's staged inputs and a function that grows one tree from
    them (treelearner/device.py:_grow) into the learner's buffers."""
    from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner, _grow

    rng = np.random.RandomState(29 + L)
    X = rng.normal(size=(n, 10))
    X[rng.rand(n, 10) < 0.05] = np.nan
    y = (X[:, 0] + X[:, 3] > 0).astype(np.float64)
    cfg = Config({"objective": "binary", "num_leaves": L, "min_data_in_leaf": 5,
                  "verbosity": -1})
    learner = DeviceTreeLearner(cfg, Dataset.from_matrix(X, label=y, config=cfg),
                                torch.device(device))
    g = np.round(rng.normal(0, 0.4, n) * 16) / 16
    if stump:  # zero gradients: every split's gain is 0, so the root is done
        g[:] = 0.0
    h = np.round(rng.uniform(0.0625, 0.25, n) * 16) / 16
    leaf0 = np.where((rng.rand(n) < 0.3) & bagged, -1, 0).astype(np.int32)
    gh = np.stack([g, h, np.ones(n)], 1).astype(np.float32)
    gh[leaf0 < 0] = 0.0
    fmask = rng.rand(len(learner.meta.real_feature)) < 0.7

    def grow():
        return _grow(learner.bins_dev, torch.from_numpy(gh).to(device),
                     torch.from_numpy(leaf0).to(device), learner.meta, learner.tables,
                     learner.params_dev, torch.from_numpy(fmask).to(device) if masked else None,
                     L, learner.group_bin_padded, learner.config.max_depth, K, bagged,
                     learner._buffers)

    return grow


TREE_CASES = [
    # (K, bagged, masked, L, stump)
    (21, False, False, 255, False),
    (21, True, True, 255, False),
    (1, False, True, 255, False),
    (1, True, False, 63, False),
    (21, False, False, 2, False),
    (1, True, False, 2, False),
    (21, False, True, 3, False),
    (1, False, False, 3, False),
    (21, False, False, 255, True),
    (1, True, True, 63, True),
]


@pytest.mark.parametrize("case", TREE_CASES,
                         ids=[f"k{c[0]}-l{c[3]}{'-bagged' if c[1] else ''}"
                              f"{'-masked' if c[2] else ''}{'-stump' if c[4] else ''}"
                              for c in TREE_CASES])
def test_tree_graph_equals_the_host_loop(cuda, case, monkeypatch):
    """The tree graph (the loop's condition set by wave1's replay) against
    `_waves_eager` on the card, from the same staged inputs."""
    from lightgbm_tpu_torch.treelearner import device as dmod

    K, bagged, masked, L, stump = case
    grow = _tree_case(cuda, K, bagged, masked, L, stump)
    grow().result()  # the captures and the tree graph
    before = dict(wave_cuda.launches)
    graphed = grow()
    got = graphed.result()
    assert graphed.graphed
    passes = graphed.waves_launched // 2
    grew = {k: wave_cuda.launches[k] - before[k] for k in before}
    assert grew == {"wave_select": 2 * passes, "wave_replay": 2 * passes,
                    "tree_loop_cond": 1}
    assert (passes == 0) == stump and (got[1] == 1) == stump  # a stump keeps its root

    class Eager:
        def __init__(self, buf, bagged, num_leaves, root, wave):
            self.args = (buf, 1 if bagged else 0, wave, num_leaves)
            self.root = root

        def launch(self):
            self.root()
            dmod._waves_eager(*self.args)

    monkeypatch.setattr(dmod, "_tree_graph", lambda buf, K, masked, bagged, L, root, wave:
                        Eager(buf, bagged, L, root, wave))
    monkeypatch.setattr(dmod._Grown, "_count", lambda self, passes: None)
    eager = _tree_case(cuda, K, bagged, masked, L, stump)()
    want = eager.result()
    assert not eager.buffers.trees
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    assert got[1:] == want[1:]
    assert graphed.waves_launched == eager.waves_launched
    assert torch.equal(graphed.leaf_id, eager.leaf_id)


def test_tree_graph_without_a_replay_in_wave1_raises(cuda):
    """lgbt_tree_graph patches wave1's replay launch; a wave1 that holds
    none, or no pass allowed, fails the build with a CUDA error, and
    TreeGraph raises (nothing falls back to a condition kernel a pass)."""
    from lightgbm_tpu_torch.ops.cuda_build import CountedGraph
    from lightgbm_tpu_torch.ops.wave import SCALARS

    x = torch.zeros(1024, device=cuda)
    scalars = torch.zeros(SCALARS, dtype=torch.int64, device=cuda)
    passes = torch.zeros(1, dtype=torch.int64, device=cuda)
    x.add_(1.0)  # PyTorch's kernel loaded before the captures
    graphs = [CountedGraph(lambda: x.add_(1.0)) for _ in range(3)]
    with pytest.raises(RuntimeError, match="building the tree graph"):
        wave_cuda.TreeGraph(graphs[0].graph, graphs[1].graph, graphs[2].graph, scalars,
                            passes, max_passes=4)
    with pytest.raises(RuntimeError, match="building the tree graph"):
        wave_cuda.TreeGraph(graphs[0].graph, graphs[1].graph, graphs[2].graph, scalars,
                            passes, max_passes=0)
