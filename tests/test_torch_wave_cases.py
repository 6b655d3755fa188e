"""The wave's cases, shared by the CPU parity tests
(tests/test_torch_compact.py and tests/test_torch_wave_step.py, against the
JAX wave and the former host code) and the card's
(tests/test_torch_cuda_train.py, the kernels against the plain versions):
a leaf-contiguous row layout with K selected ranges and real decision
tables, as the wave learner builds them, and a tree's device state with a
wave's children, as the selection and the replay read them. Imported by
module name (pytest puts this directory on the path); it imports no JAX.
"""
import numpy as np
import torch

WAVE_N, WAVE_G = 3000, 6
# (name, leaves, selected ranges, of which invalid, selection order, form)
WAVE_CASES = [
    ("k1", 3, 1, 0, "sorted", "wave"),
    ("k4", 9, 4, 0, "sorted", "wave"),
    ("k21_unsorted", 30, 21, 0, "shuffled", "wave"),
    ("untouched", 12, 4, 2, "shuffled", "wave"),
    ("bagged", 1, 1, 0, "sorted", "bagged"),
    ("pending_relabel", 12, 5, 1, "shuffled", "relabel"),
]


def wave_case(seed, n_leaves, K, n_invalid, order, form, N=WAVE_N, G=WAVE_G):
    """One wave's inputs, leaf-contiguous as the wave learner keeps them:
    n_leaves leaves over [0, N) with bagged-out rows (leaf -1) at the end,
    K of them selected in `order` (the last n_invalid of the selection
    invalid, as a selected leaf whose gain is not positive), each selected
    range's split on a random feature layout (plain or EFB, every missing
    type). The bagged form: one leaf 0 of in-bag rows scattered among
    bagged-out ones. Returns a dict of numpy arrays."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, 256, size=(G, N)).astype(np.uint8)
    row = rng.randn(N, 5).astype(np.float32)
    row[:, 3] = np.arange(N)
    row[7, 1] = np.float32("nan")
    row[8, 0] = -0.0
    if form == "bagged":
        row[:, 4] = np.where(rng.rand(N) < 0.7, 0.0, -1.0)
        return dict(bins=bins, row=row, starts=np.array([0], np.int32),
                    counts=np.array([N], np.int32), valid=np.array([1], np.int32), K=1)
    n_out = N // 10
    cuts = np.sort(rng.choice(np.arange(1, N - n_out), n_leaves - 1, replace=False))
    edges = np.concatenate([[0], cuts, [N - n_out]]).astype(np.int64)
    ids = rng.permutation(n_leaves)
    leaf_of = np.full(N, -1, np.int64)
    for j in range(n_leaves):
        leaf_of[edges[j]:edges[j + 1]] = ids[j]
    row[:, 4] = leaf_of
    start = np.zeros(n_leaves, np.int64)
    count = np.zeros(n_leaves, np.int64)
    start[ids] = edges[:-1]
    count[ids] = np.diff(edges)
    relabel = None
    if form == "relabel":
        # the previous wave's commit, still to apply to the leaf-id column:
        # two leaves split, their right rows [mid, end) new leaves
        par = np.argsort(-count, kind="stable")[:2]
        mid = start[par] + count[par] // 3
        relabel = np.stack([mid, start[par] + count[par],
                            n_leaves + np.arange(2)]).astype(np.int64)
        start = np.concatenate([start, mid])
        count = np.concatenate([count, start[par] + count[par] - mid])
        count[par] = mid - start[par]
        n_leaves += 2
    sel = rng.choice(n_leaves, K, replace=False)
    if order == "sorted":
        sel = np.sort(sel)
    sel_ok = np.ones(K, bool)
    sel_ok[K - n_invalid:] = False
    # each range's split: a feature of a random layout and a threshold
    is_efb = rng.rand(K) < 0.5
    lo = np.where(is_efb, rng.randint(1, 120, K), 0)
    nbins = np.where(is_efb, rng.randint(3, 100, K), rng.randint(2, 256, K))
    hi = np.where(is_efb, lo + nbins - 1, nbins)
    fields = dict(group=rng.randint(0, G, K).astype(np.int32), lo=lo.astype(np.int32),
                  hi=hi.astype(np.int32), default_bin=rng.randint(0, 2, K) * (nbins - 1) // 2,
                  nbins=nbins.astype(np.int32), missing_type=rng.randint(0, 3, K),
                  is_efb=is_efb, thresh=rng.randint(0, 255, K) % nbins,
                  default_left=rng.rand(K) < 0.5)
    fields["default_bin"] = fields["default_bin"].astype(np.int32)
    fields["missing_type"] = fields["missing_type"].astype(np.int32)
    leaf2k = np.full(n_leaves + 2, K, np.int32)
    leaf2k[sel[sel_ok] + 1] = np.nonzero(sel_ok)[0]
    case = dict(bins=bins, row=row, starts=start[sel].astype(np.int32),
                counts=count[sel].astype(np.int32), valid=sel_ok.astype(np.int32),
                leaf2k=leaf2k, sel=sel, sel_ok=sel_ok, fields=fields, K=K)
    if relabel is not None:
        case["relabel"] = relabel
    return case


def wave_tables(case):
    """The port's K-entry tables of a case: rgroup [K] and the [K, 256]
    decision table (ops/wave.py:decision_table)."""
    from lightgbm_tpu_torch.ops.wave import FeatureTables, decision_table

    f = case["fields"]
    K = case["K"]
    t = torch.from_numpy
    tables = FeatureTables(t(f["group"]), t(f["lo"]), t(f["hi"]), t(f["default_bin"]),
                           t(f["nbins"]), t(f["missing_type"]), t(f["is_efb"]))
    lut = decision_table(tables, torch.arange(K), t(f["thresh"]),
                         t(f["default_left"])).numpy().astype(np.int32)
    lut[~case["sel_ok"]] = 0
    return f["group"], lut


def partition_inputs(case):
    """partition_wave's arguments of a case, as CPU tensors."""
    t = torch.from_numpy
    if "fields" not in case:
        return [None, None, None, t(case["starts"]), t(case["counts"]), t(case["valid"])]
    rgroup, lut = wave_tables(case)
    return [t(case["leaf2k"]), t(rgroup), t(lut), t(case["starts"]), t(case["counts"]),
            t(case["valid"])]




def wave_tables_random(rng, n_features):
    """Random decision fields of n_features dense features over 4 groups,
    in FeatureTables' order: group, lo, hi, default_bin, nbins,
    missing_type (int32) and is_efb (bool), numpy."""
    F = n_features
    nbins = rng.randint(2, 256, F).astype(np.int32)
    is_efb = rng.rand(F) < 0.4
    lo = np.where(is_efb, rng.randint(1, 100, F), 0).astype(np.int32)
    return (rng.randint(0, 4, F).astype(np.int32), lo,
            (lo + np.where(is_efb, nbins - 1, nbins)).astype(np.int32),
            (rng.randint(0, 2, F) * (nbins - 1) // 2).astype(np.int32), nbins,
            rng.randint(0, 3, F).astype(np.int32), is_efb)


def wave_state(rng, L, n_cur, gains=None, n_features=6):
    """A tree's state (ops/wave.py) after n_cur - 1 splits, numpy: n_cur
    leaves with records on n_features features, disjoint row ranges over
    10,000 rows, a split log of n_cur - 1 rows, live."""
    from lightgbm_tpu_torch.ops.wave import REC, STORE

    F = n_features
    leaf_best = np.full((L + 1, REC), -np.inf, np.float32)
    recs = rng.normal(size=(n_cur, REC)).astype(np.float32)
    recs[:, 0] = (np.round(rng.normal(1.0, 2.0, n_cur) * 4) / 4 if gains is None
                  else np.asarray(gains, np.float32))
    recs[:, 1] = rng.randint(0, F, n_cur)
    recs[:, 2] = rng.randint(0, 40, n_cur)
    recs[:, 3] = rng.rand(n_cur) < 0.5
    leaf_best[:n_cur] = recs
    cuts = np.sort(rng.choice(np.arange(1, 10000), n_cur - 1, replace=False))
    edges = np.concatenate([[0], cuts, [10000]])
    order = rng.permutation(n_cur)
    start = np.zeros(L + 1, np.int32)
    count = np.zeros(L + 1, np.int32)
    start[order] = edges[:-1]
    count[order] = np.diff(edges)
    depth = np.zeros(L + 1, np.int32)
    depth[:n_cur] = rng.randint(0, 5, n_cur)
    rec_store = np.zeros((max(L - 1, 1) + 1, STORE), np.float32)
    rec_store[:n_cur - 1] = rng.normal(size=(n_cur - 1, STORE))
    scalars = np.array([n_cur, n_cur - 1, 12345, 3, 0], np.int64)
    return dict(leaf_best=leaf_best, depth=depth, start=start, count=count,
                rec_store=rec_store, scalars=scalars)


def wave_children(rng, st, sel, sel_ok, gains=None, g_sum=None, n_features=6):
    """The 2K children's records and totals and the K left counts of a wave
    over `st`'s leaves sel: counts from the ranges' sizes, hessians and
    gradients snapped to 1/16."""
    from lightgbm_tpu_torch.ops.wave import REC

    F = n_features
    K = sel.shape[0]
    c_k = st["count"][sel].astype(np.int64)
    nl = np.array([rng.randint(0, c + 1) for c in c_k], np.int64)
    recs2 = rng.normal(size=(2 * K, REC)).astype(np.float32)
    recs2[:, 0] = (np.round(rng.normal(1.0, 2.0, 2 * K) * 4) / 4 if gains is None
                   else np.asarray(gains, np.float32))
    recs2[:, 1] = rng.randint(0, F, 2 * K)
    recs2[:, 2] = rng.randint(0, 40, 2 * K)
    totals2 = np.zeros((2 * K, 3), np.float32)
    totals2[:, 2] = np.stack([nl, c_k - nl], 1).reshape(-1)
    totals2[:, 1] = np.round(totals2[:, 2] * rng.uniform(0.01, 0.3, 2 * K) * 16) / 16
    totals2[:, 0] = (np.round(rng.normal(0, 30, 2 * K) * 16) / 16 if g_sum is None
                     else np.asarray(g_sum, np.float32))
    return recs2, totals2, nl.astype(np.int32)


# The selection's and the replay's edge states: (name, L, K, leaves, seed).
WAVE_EDGES = [
    ("nan_gains", 31, 8, 12, 41),  # NaN gains: they rank first and stop the replay
    ("nan_child", 31, 6, 10, 42),  # a committed child's NaN gain stops it mid-wave
    ("signed_zero_tie", 31, 12, 14, 43),  # -0.0 and +0.0 gains tie, the lower leaf first
    ("k1", 15, 1, 6, 44),
    ("k_equals_l", 15, 15, 9, 45),
    ("l1024", 1024, 64, 700, 46),  # the selection's sort, at its widest
    ("l1025", 1025, 21, 600, 47),  # the selection's radix select, at its narrowest
    ("l4100", 4100, 21, 3000, 48),  # above 4,096 leaves
    ("l4100_k1024", 4100, 1024, 2500, 49),
    ("done", 31, 8, 12, 50),  # the tree is done: nothing selected or committed
    ("budget_mid_wave", 16, 8, 12, 51),  # t reaches L - 1 with selections left
    ("max_depth_gate", 31, 8, 10, 52),  # max_depth gates some children, not others
    ("new_leaf_selected", 31, 6, 8, 53),  # a valid selection among the leaves the wave creates
]


def wave_edge(name):
    """One of WAVE_EDGES: the state (numpy, wave_state's), the feature
    tables, K, the children of the plain selection's ranges (recs2, totals2,
    n_left), params [6] float32 and max_depth. The children are built on the
    plain version's selection, so the kernels' and the oracle's replays see
    the same ranges."""
    from lightgbm_tpu_torch.ops.wave import DONE, FeatureTables, select_wave, split_select

    _, L, K, n_cur, seed = next(e for e in WAVE_EDGES if e[0] == name)
    rng = np.random.RandomState(seed)
    gains = np.round(rng.normal(2.0, 2.0, n_cur) * 4) / 4
    child_gains, max_depth = None, -1
    params = np.array([0.0, 0.5, 5.0, 1e-3, 0.0, 0.4], np.float32)
    if name == "nan_gains":
        gains[[2, 5, 9]] = np.nan
    elif name == "signed_zero_tie":
        gains[[0, 3, 4, 7, 8, 11]] = [-0.0, 0.0, -0.0, 0.0, -0.0, 0.0]
        gains[[1, 5]] = -1.0
    st = wave_state(rng, L, n_cur, gains=gains)
    if name == "done":
        st["scalars"][DONE] = 1
    elif name == "max_depth_gate":
        st["depth"][:n_cur] = rng.choice([1, 2], n_cur)
        max_depth = 3
    elif name == "new_leaf_selected":
        # leaves n_cur .. n_cur + 3 hold records and rows: selected and
        # valid, and also the ids the wave's commits give their new leaves
        st["leaf_best"][n_cur:n_cur + 4] = st["leaf_best"][:4]
        st["leaf_best"][n_cur:n_cur + 4, 0] = [3.0, 9.0, 5.0, 0.5]
        st["count"][n_cur:n_cur + 4] = 10
    tables = wave_tables_random(rng, 6)
    table = select_wave(*(torch.from_numpy(st[k].copy()) for k in
                          ("leaf_best", "start", "count", "scalars")),
                        FeatureTables(*(torch.from_numpy(a) for a in tables)), K)
    parts = split_select(table, L, K)
    sel, ok = parts[5].numpy(), parts[4].numpy() != 0
    if name == "nan_child":
        child_gains = np.round(rng.normal(1.0, 2.0, 2 * K) * 4) / 4
        child_gains[1] = np.nan  # the right child of the best range
    elif name == "signed_zero_tie":
        child_gains = np.resize([-0.0, 0.0, 1.5, -0.0], 2 * K)
    elif name == "budget_mid_wave":
        child_gains = np.full(2 * K, 0.5)
    recs2, totals2, nl = wave_children(rng, st, sel, ok, gains=child_gains)
    return dict(state=st, tables=tables, K=K, recs2=recs2, totals2=totals2, n_left=nl,
                params=params, max_depth=max_depth)


def test_wave_case_is_leaf_contiguous():
    """Every case holds the partition's precondition: a selected valid
    range is exactly the positions of the rows its leaf2k entry names."""
    for name, n_leaves, K, n_invalid, order, form in WAVE_CASES:
        case = wave_case(3, n_leaves, K, n_invalid, order, form)
        leaf = case["row"][:, 4].astype(np.int64)
        if "relabel" in case:
            for mid, end, new in case["relabel"].T:
                leaf[mid:end] = new
        rng = (np.zeros(WAVE_N, np.int64) if form == "bagged"
               else case["leaf2k"][leaf + 1])
        for k, (s, c, ok) in enumerate(zip(case["starts"], case["counts"], case["valid"])):
            if ok:
                assert (rng[s:s + c] == k).all() and (rng[:s] != k).all() \
                    and (rng[s + c:] != k).all()
            else:
                assert (rng != k).all()
