"""The single-pass row partition's host side and position arithmetic
(`ops/partition_cuda.py`, `csrc/row_partition.cu`), on the CPU.

The kernel runs only on the card; here a numpy emulation of it (tickets
from the state buffer's word 0, a ballot of go-left bits a tile, the
look-back over 64-bit status words tagged with the call's epoch, each row
written at its rank and the mirrored padding: a row of right rank j writes
left[count - 1 - j] = N, a row of left rank i writes right[count - 1 - i] =
N) is held against `_split_rows_plain` on both children and n_left, at
counts 0, 1, 31, 32, 1,023, 1,024, 1,025, 4,095, 4,096, 4,097, several
tiles of each size (1,024 positions up to 2**18, 4,096 above), P > count,
all rows left and all rows right, and 512 tiles. Some
earlier tiles are left with only their own count published, so the
look-back adds through them to the nearest inclusive prefix, across
windows of 256 tiles. The wrapper's tile count,
the state buffer's size, its epochs and tickets, and its zeroing when the
epoch wraps are checked directly; the look-back never reads a word of an
earlier call. The card's kernel is held to the plain version in
tests/test_torch_cuda_train.py.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import partition_cuda
from lightgbm_tpu_torch.ops.partition import _split_rows_plain

WINDOW = 256  # tiles a block's look-back reads at once (csrc/row_partition.cu kThreads)
EPOCH_SHIFT, COUNT_ONLY, PREFIX, VALUE = 33, 1 << 31, 2 << 31, (1 << 31) - 1


def _emulate(bins_row, idx, count, table, n_data, states, rng):
    """The kernel's arithmetic, block by block in ticket order."""
    P = idx.shape[0]
    size = partition_cuda.tile(P)
    n_tiles = partition_cuda.tiles(P)
    buf, ticket0, epoch = states.take(n_tiles)
    state = buf.numpy().view(np.uint64)
    tag = epoch << EPOCH_SHIFT
    left = np.full(P, -1, np.int64)
    right = np.full(P, -1, np.int64)
    n_left = []
    for _ in range(n_tiles):
        if n_tiles == 1:
            tile = 0
        else:
            tile = int(state[0]) - ticket0
            state[0] += np.uint64(1)
        ts = tile * size
        n = max(0, min(size, count - ts))
        rows = idx[ts:ts + n]
        go = table[bins_row[np.minimum(rows, n_data - 1)]]
        total = int(go.sum())
        before = 0
        if n > 0 and n_tiles > 1:
            if tile > 0:
                state[1 + tile] = np.uint64(tag | COUNT_ONLY | total)
                j = tile - 1
                while True:  # a window of WINDOW tiles, nearest first
                    window = []
                    for lane in range(WINDOW):
                        q = j - lane
                        s = int(state[1 + q]) if q >= 0 else tag | PREFIX
                        assert s >> EPOCH_SHIFT == epoch, "read a word of another call"
                        window.append(s)
                    hit = [lane for lane, s in enumerate(window) if s & PREFIX]
                    stop = hit[0] if hit else WINDOW - 1
                    before += sum(s & VALUE for s in window[:stop + 1])
                    if hit:
                        break
                    j -= WINDOW
            # publish the inclusive prefix, or (as a tile that has not yet
            # got that far) leave only its own count for later tiles to add
            if tile == 0 or rng.rand() < 0.5:
                state[1 + tile] = np.uint64(tag | PREFIX | (before + total))
        if (n > 0 and ts + n == count) or (count == 0 and tile == 0):
            n_left.append(before + total)
        i = before + np.concatenate([[0], np.cumsum(go)[:-1]]).astype(np.int64)  # left ranks
        j = ts + np.arange(n) - i                                                 # right ranks
        left[i[go]] = rows[go]
        right[count - 1 - i[go]] = n_data
        right[j[~go]] = rows[~go]
        left[count - 1 - j[~go]] = n_data
        pad = np.arange(max(ts, count), min(ts + size, P))
        left[pad] = n_data
        right[pad] = n_data
    assert len(n_left) == 1
    return left, right, n_left[0]


# (N, P, count, table)
CASES = [(5000, 256, 0, "random"), (5000, 256, 1, "random"), (5000, 256, 31, "random"),
         (5000, 256, 32, "random"), (5000, 1024, 1023, "random"),
         (5000, 1024, 1024, "random"), (5000, 2048, 1025, "random"),
         (5000, 4096, 3000, "left"), (5000, 4096, 3000, "right"),
         (300001, 65536, 40001, "random"), (300001, 262144, 140001, "random"),
         (200000, 131072, 131072, "random"), (4000, 8192, 1, "random"),
         (300001, 8192, 4095, "random"), (300001, 8192, 4096, "random"),
         (300001, 8192, 4097, "random"), (2100000, 1 << 21, 2000000, "random"),
         (300001, 1 << 18, 262144, "random"), (300001, 524288, 262145, "right")]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[2]}of{c[1]}-{c[3]}" for c in CASES])
def test_single_pass_arithmetic_equals_plain(case):
    N, P, count, kind = case
    rng = np.random.RandomState(N + P + count)
    bins_row = rng.randint(0, 256, size=N).astype(np.uint8)
    idx = np.full(P, N, np.int32)
    idx[:count] = np.sort(rng.choice(N, count, replace=False))
    table = {"random": rng.rand(256) < 0.5, "left": np.ones(256, bool),
             "right": np.zeros(256, bool)}[kind]
    ref = _split_rows_plain(torch.from_numpy(bins_row), torch.from_numpy(idx), count, table, N)
    states = partition_cuda.TileStates(torch.device("cpu"))
    for _ in range(2):  # a second call on the same buffer: new epoch, later tickets
        left, right, n_left = _emulate(bins_row, idx, count, table, N, states, rng)
        assert n_left == int(ref[2])
        assert np.array_equal(left, ref[0].numpy()) and np.array_equal(right, ref[1].numpy())


def test_tiles_and_state_words():
    assert [partition_cuda.tiles(p) for p in (1, 1023, 1024, 1025, 1 << 18)] == [1, 1, 1, 2,
                                                                                  256]
    # past 2**18 positions a tile is 4,096
    assert [partition_cuda.tiles(p) for p in ((1 << 18) + 1, 1 << 20, 1 << 21)] == [65, 256, 512]
    assert partition_cuda.tile(1 << 18) == 1024 and partition_cuda.tile((1 << 18) + 1) == 4096
    assert partition_cuda.state_words(1) == 2
    assert partition_cuda.state_words(3) == 4
    assert partition_cuda.state_words(1024) == 2048
    for n in range(1, 300):
        w = partition_cuda.state_words(n)
        assert w >= n + 1 and w & (w - 1) == 0


def test_state_buffer_epochs_tickets_growth_and_wrap(monkeypatch):
    states = partition_cuda.TileStates(torch.device("cpu"))
    buf, ticket0, epoch = states.take(4)
    assert buf.dtype == torch.int64 and buf.shape[0] == 8 and not buf.any()
    assert (ticket0, epoch) == (0, 1)
    buf2, ticket0, epoch = states.take(1)  # one tile: no ticket, a new epoch
    assert buf2 is buf and (ticket0, epoch) == (4, 2)
    _, ticket0, epoch = states.take(7)
    assert (ticket0, epoch, states.tickets) == (4, 3, 11)
    buf[:] = 5
    grown, ticket0, epoch = states.take(8)  # 9 words: a new, zeroed buffer
    assert grown is not buf and grown.shape[0] == 16 and not grown.any()
    assert (ticket0, epoch) == (0, 1)
    monkeypatch.setattr(partition_cuda, "EPOCH_LIMIT", 4)
    grown.fill_(9)
    _, _, epoch = states.take(2)
    assert epoch == 2 and bool((grown == 9).all())
    _, ticket0, epoch = states.take(2)  # the last epoch below the limit
    assert (ticket0, epoch) == (10, 3) and bool((grown == 9).all())
    _, ticket0, epoch = states.take(2)  # epoch 4 would reach it: zeroed, epoch 1
    assert (ticket0, epoch) == (0, 1) and not grown.any()
    states.drop()
    fresh, ticket0, epoch = states.take(2)
    assert fresh is not grown and (ticket0, epoch) == (0, 1)


def test_state_buffers_are_per_device_and_stream():
    cpu = torch.device("cpu")
    a = partition_cuda.tile_states(cpu, 11)
    assert partition_cuda.tile_states(cpu, 11) is a
    assert partition_cuda.tile_states(cpu, 12) is not a


def test_launch_counter_has_one_name():
    assert set(partition_cuda.launches) == {"row_partition"}


def test_state_buffers_under_threads():
    """Threads that share a stream share its buffer, and under its lock each
    call takes its own epoch and tickets: none lost."""
    import sys
    import threading

    cpu = torch.device("cpu")
    got, errors = [], []

    def work(k):
        try:
            for _ in range(200):
                states = partition_cuda.tile_states(cpu, 1000 + k % 2)
                with states.lock:
                    _, ticket0, epoch = states.take(3)
                got.append((k % 2, id(states), ticket0, epoch))
        except Exception as e:  # a failure must reach the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for stream in (0, 1):
        mine = [g for g in got if g[0] == stream]
        assert len({g[1] for g in mine}) == 1 and len(mine) == 8 * 200
        assert sorted(g[3] for g in mine) == list(range(1, 1601))
        assert sorted(g[2] for g in mine) == list(range(0, 3 * 1600, 3))
