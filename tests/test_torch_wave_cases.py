"""The wave partition's cases, shared by the CPU parity tests
(tests/test_torch_compact.py, against the JAX wave) and the card's
(tests/test_torch_cuda_train.py, the kernels against the plain version):
a leaf-contiguous row layout with K selected ranges and real decision
tables, as the wave learner builds them. Imported by module name (pytest
puts this directory on the path); it imports no JAX.
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
    decision table (treelearner/device.py:_decision_table)."""
    from lightgbm_tpu_torch.treelearner.device import FeatureTables, _decision_table

    f = case["fields"]
    K = case["K"]
    tables = FeatureTables(f["group"], f["lo"], f["hi"], f["default_bin"], f["nbins"],
                           f["missing_type"], f["is_efb"])
    lut = _decision_table(tables, np.arange(K), f["thresh"], f["default_left"])
    lut = lut.astype(np.int32)
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
