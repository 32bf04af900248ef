"""Kernels C1 and F1's decompositions, emulated on the CPU.

C1 (``csrc/threefry.cu`` ``threefry_categorical_kernel``) and F1
(``csrc/fullview.cu`` ``fullview_apply_kernel``) run only on the card.
Their index arithmetic is emulated here in numpy, step for step as the
kernels take it, with the block sizes and run lengths read from the
sources, and held to the plain versions (``sim/threefry.py:
categorical_masked_plain``, ``ops/fullview_kernel.py:apply_plain``), which
``tests/test_torch_threefry.py`` and ``tests/test_torch_fullview.py`` hold
to the JAX package:

* C1: a warp draws one (row, rep); runs of ``RUN`` elements aligned to the
  mask's address (partial head and tail runs); runs barred whole run no
  cipher; an element's key (its top 23 bits, ``RUN - k`` below) and the
  run's unsigned max; the strict compare across a lane's runs; the warp's
  butterfly; ties built on purpose; rows that allow nothing (found by the
  warp's pass, then drawn whole); a lone allowed entry in the last column;
  runs whose counters carry into the high word mid-run, against the plain
  version's ``rows=``;
* F1: a group of four cells a thread, the grid over the plane without
  wrapping; each group's row from the 32-bit reciprocal of N, its cells
  straddling a row end where N % 4 != 0, the diagonal; every leg of the
  engine's tick; and the launcher's refusal of planes the kernel's word
  loads cannot take.

The tolerance is none.
"""

import re

import numpy as np
import pytest
import torch

from ringpop_tpu_torch.ops import fullview_kernel as fk
from ringpop_tpu_torch.ops import threefry_kernel as tk
from ringpop_tpu_torch.sim import fullview as tfv
from ringpop_tpu_torch.sim import prng
from ringpop_tpu_torch.sim import threefry as tf

M32 = 0xFFFFFFFF
CODE = 0x1FF  # the low 9 bits of a C1 key: RUN - k
NO_INDEX = 0x7FFFFFFF


def _constant(source, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source.read_text()).group(1))


RUN = _constant(tk.SOURCE, "kRun")
C1_THREADS = _constant(tk.SOURCE, "kC1Threads")
F1_THREADS = _constant(fk.SOURCE, "kThreads")


# -- C1 ------------------------------------------------------------------------


def _threefry_bits(key):
    """bits(hi, lo) = the xor of threefry2x32's words on counters (hi, lo)."""
    def bits(hi, lo):
        b1, b2 = tf.threefry2x32(key[0], key[1], torch.as_tensor(hi.astype(np.int64)),
                                 torch.as_tensor(lo.astype(np.int64)))
        return (b1 ^ b2).numpy().astype(np.uint64)
    return bits


def _first_max(pairs):
    """``take_first_max`` over (value, index) pairs in order."""
    best, at = -1, NO_INDEX
    for value, index in pairs:
        if value > best or (value == best and index < at):
            best, at = value, index
    return best, at


def _warp_first_max(best, at):
    """``warp_first_max``: five butterfly steps; every lane takes the pair of
    the lane ``offset`` away and keeps the first max.  Returns every lane's
    pair."""
    best, at = list(best), list(at)
    for offset in (16, 8, 4, 2, 1):
        best, at = map(list, zip(*(_first_max([(best[i], at[i]), (best[i ^ offset], at[i ^ offset])])
                                   for i in range(32))))
    return list(zip(best, at))


def _warp_pass(bits, mask_row, row, rep, reps, off, whole, stats):
    """``warp_draw``: one pass of a warp over a row whose mask starts
    ``off`` bytes past a multiple of RUN, for one rep; every lane's result
    (the warp's first max)."""
    n = mask_row.size
    runs = (off + n + RUN - 1) // RUN
    t = np.arange(runs)
    j0 = t * RUN - off
    jj = j0[:, None] + np.arange(RUN)
    inside = (jj >= 0) & (jj < n)
    mk = inside if whole else inside & (mask_row[np.clip(jj, 0, n - 1)] != 0)
    drawn = mk.any(axis=1)  # a run barred whole runs no cipher
    k = np.arange(RUN, dtype=np.uint64)
    base = (row * reps + rep) * n
    c0 = np.full(runs, base, np.uint64) + j0.astype(np.int64).astype(np.uint64)  # wraps below 0
    hi, lo = c0 >> np.uint64(32), c0 & np.uint64(M32)
    carry = lo > M32 - (RUN - 1)
    fast = mk.all(axis=1) & ~carry
    c = (lo[:, None] + k) & np.uint64(M32)
    hi_k = np.where(fast[:, None], hi[:, None], (hi[:, None] + (c < lo[:, None])) & np.uint64(M32))
    key = np.zeros((runs, RUN), np.uint64)
    if drawn.any():
        key[drawn] = (bits(hi_k[drawn], c[drawn]) & np.uint64(M32 ^ CODE)) | (np.uint64(RUN) - k)
    top = np.where(mk, key, 0).max(axis=1)
    stats["ciphers"] += int(drawn.sum()) * RUN
    stats["carry_runs"] += int((drawn & carry).sum())
    best, at = [-1] * 32, [NO_INDEX] * 32
    for ti in np.flatnonzero(drawn):  # a lane's runs rise: the strict compare keeps the first
        lane, value = ti % 32, int(top[ti]) >> 9
        if top[ti] and value > best[lane]:
            best[lane], at[lane] = value, int(j0[ti]) + RUN - (int(top[ti]) & CODE)
    return _warp_first_max(best, at)


def _c1_warp(bits, mask_row, row, rep, reps, off, stats):
    """The warp drawing (row, rep), as the kernel does: a pass that drew
    nothing (the row allows nothing) is followed by a pass over the whole
    row."""
    lanes = _warp_pass(bits, mask_row, row, rep, reps, off, False, stats)
    assert len(set(lanes)) == 1  # every lane holds the warp's pair
    if lanes[0][0] < 0:
        lanes = _warp_pass(bits, mask_row, row, rep, reps, off, True, stats)
    return lanes[0][1]


def c1_emulate(key, mask, reps=None, rows=None, mask_off=0, bits=None, stats=None):
    """C1's answer for ``rows`` (all by default) of ``mask`` (numpy or
    torch, [R, N]), whose base address is ``mask_off`` bytes past a multiple
    of RUN; ``bits`` the draw (threefry by default)."""
    n_rows, n = mask.shape
    bits = bits or _threefry_bits(key)
    stats = {"ciphers": 0, "carry_runs": 0} if stats is None else stats
    r = reps or 1
    out = []
    for row in (range(n_rows) if rows is None else rows):
        m = mask[row]
        m = m.numpy() if isinstance(m, torch.Tensor) else m
        off = (mask_off + int(row) * n) % RUN
        out.append([_c1_warp(bits, m, int(row), rep, r, off, stats) for rep in range(r)])
    out = np.array(out, dtype=np.int64).reshape(-1, r)
    return out[:, 0] if reps is None else out


def _mask(rows, cols, density, seed):
    """Rows 0-2 allow nothing, everything and only the last entry."""
    m = np.random.default_rng(seed).random((rows, cols)) < density
    if rows >= 3:
        m[0], m[1], m[2] = False, True, False
        m[2, -1] = True
    return m


def test_c1_reads_its_run_and_block_from_the_source():
    """A run's mask bytes are one 8-byte load, and the grid's warps (a block
    of whole warps) take every (row, rep) once."""
    assert RUN == 8 and C1_THREADS % 32 == 0
    warps = C1_THREADS // 32
    for units in (1, 7, 8, 9, 3000):
        blocks = -(-units // warps)
        q = np.arange(blocks)[:, None] * warps + np.arange(warps)
        assert np.array_equal(q[q < units], np.arange(units))


@pytest.mark.parametrize("mask_off", range(8))
@pytest.mark.parametrize("reps", [None, 3])
@pytest.mark.parametrize("cols", [1, 7, 31, 33, 257, 1000])
def test_c1_decomposition_matches_plain(cols, reps, mask_off):
    key = tf.split(prng.prng_key(cols, "cpu"), 3)[1]
    for i, density in enumerate((0.01, 0.5, 0.99)):
        mask = _mask(10, cols, density, 17 * cols + i)
        want = tf.categorical_masked_plain(key, torch.as_tensor(mask), reps).numpy()
        got = c1_emulate(key, mask, reps, mask_off=mask_off)
        assert np.array_equal(want, got), (density, np.argwhere(want != got)[:4].tolist())


def test_c1_runs_barred_whole_run_no_cipher():
    """Where a row allows something, a run whose mask bytes are all 0 runs no
    cipher; a row that allows nothing draws every run."""
    key = prng.prng_key(5, "cpu")
    n = 200
    mask = np.zeros((3, n), bool)
    mask[0, 17] = mask[0, 150] = True  # two runs drawn
    mask[1, :RUN] = True  # one run drawn
    stats = {"ciphers": 0, "carry_runs": 0}
    got = c1_emulate(key, mask, 3, stats=stats)
    assert np.array_equal(got, tf.categorical_masked_plain(key, torch.as_tensor(mask), 3).numpy())
    assert stats["ciphers"] == 3 * (2 + 1 + n // RUN) * RUN, stats  # row 2 allows nothing: all of it
    assert set(got[0].tolist()) <= {17, 150} and set(got[1].tolist()) <= set(range(RUN))


@pytest.mark.parametrize("mask_off", [0, 3, 5])
def test_c1_ties_go_to_the_first_index(mask_off):
    """Draws built with ties on purpose: every element equal (the first
    allowed index wins, across runs and lanes), and four values
    only, against numpy's first argmax of the masked draw."""
    n = 1000
    mask = _mask(12, n, 0.3, 3)
    flat = lambda row, rep, j: (row * 2 + rep) * n + j  # noqa: E731
    for bits in (lambda hi, lo: np.full(lo.shape, 0x12345600, np.uint64),
                 lambda hi, lo: ((lo * np.uint64(2654435761)) >> np.uint64(7) & np.uint64(3)) << np.uint64(9)):
        got = c1_emulate(None, mask, 2, mask_off=mask_off, bits=bits)
        for row in range(mask.shape[0]):
            allowed = mask[row] if mask[row].any() else np.ones(n, bool)
            for rep in range(2):
                c = np.array([flat(row, rep, j) for j in range(n)], np.uint64)
                value = np.where(allowed, bits(c >> np.uint64(32), c & np.uint64(M32)).astype(np.int64) >> 9, -1)
                assert got[row, rep] == int(np.argmax(value)), (row, rep)


def test_c1_a_key_orders_by_value_then_first_index():
    """Within a run the largest key is the largest draw at its first index,
    and a barred element's key (0) is below every drawn one."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        draws = rng.integers(0, 4, RUN).astype(np.uint64) << np.uint64(9 + 20)
        keys = draws | (np.uint64(RUN) - np.arange(RUN, dtype=np.uint64))
        top = int(keys.max())
        assert RUN - (top & CODE) == int(np.argmax(draws >> np.uint64(9))) and min(keys) > 0


@pytest.mark.parametrize("n", [1, 9, 33, 1000])
def test_c1_rows_allowing_nothing_or_only_the_last_column(n):
    key = prng.prng_key(9, "cpu")
    mask = np.zeros((4, n), bool)
    mask[1, -1] = mask[3, -1] = True
    got = c1_emulate(key, mask, 3, mask_off=n % RUN)
    assert (got[1] == n - 1).all() and (got[3] == n - 1).all()
    assert np.array_equal(got, tf.categorical_masked_plain(key, torch.as_tensor(mask), 3).numpy())


@pytest.mark.parametrize("cols", [1001, 20003])
def test_c1_run_whose_counters_carry_mid_run(cols):
    """A [R, 3, N] draw whose counters pass 2**32 inside a row, N not a
    multiple of RUN: for each address offset of the mask, the rows around
    the crossing against the plain version on explicit counters; where the
    crossing falls inside a run, the generic path adds the carry."""
    reps = 3
    crossing = (1 << 32) // cols  # the (row, rep) whose counters pass 2**32
    cross_row = crossing // reps
    rows = cross_row + 2
    row_mask = np.random.default_rng(cols).random(cols) < 0.5
    mask = torch.as_tensor(row_mask).expand(rows, cols)  # every row the same, never materialised
    key = tf.split(prng.prng_key(cols, "cpu"), 2)[1]
    check = [cross_row - 1, cross_row, cross_row + 1]
    want = tf.categorical_masked_plain(key, mask, reps, rows=torch.tensor(check)).numpy()
    j_star = (1 << 32) - crossing * cols  # the first column past 2**32, in the crossing rep
    mid = 0
    for mask_off in range(RUN):
        stats = {"ciphers": 0, "carry_runs": 0}
        got = c1_emulate(key, mask, reps, rows=check, mask_off=mask_off, stats=stats)
        assert np.array_equal(want, got), mask_off
        inside = (mask_off + cross_row * cols + j_star) % RUN != 0
        assert stats["carry_runs"] == int(inside), (mask_off, stats)
        mid += inside
    assert mid == RUN - 1


# -- F1 ------------------------------------------------------------------------


def _quotient(a: int, n: int) -> int:
    """``quotient``: a // n from n's reciprocal in uint32 arithmetic."""
    magic, add, shift1, shift2 = tk.reciprocal(n)
    q = (magic * a) >> 32
    if add:
        q = (q + (((a - q) & M32) >> shift1)) & M32
    return q >> shift2


def f1_blocks(n: int) -> int:
    """The entry point's grid: a group of four cells a thread."""
    groups = -(-n * n // 4)
    return -(-groups // F1_THREADS)


def _as_i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _rules(c, diag, cell, now):
    """``apply_rules`` on (status, pending, incarnation, present)."""
    status, pending, inc, present = cell
    cand_state, cand_inc = c & 7, c >> 3
    local = _as_i32((inc << 3) | status) if present else -1
    refute = diag and cand_state in (1, 2, 4) and cand_inc >= inc and present
    wins = not refute and c > local and not (not present and cand_state == 4)
    if not (wins or refute):
        return False, False, cell
    status, inc = (0, now) if refute else (cand_state, cand_inc)
    schedule = False
    if status in (0, 3):
        pending = -1
    elif status in (1, 2, 4) and not diag and pending != status:
        pending, schedule = status, True
    return True, schedule, (status, pending, inc, True)


def f1_emulate(planes, cand, tick, now, timeouts, stats=None):
    """F1 on numpy copies of the seven planes, in place: thread t of block b
    loads the group of four cells ``b * F1_THREADS + t``; a group with a
    candidate finds its row by the reciprocal and applies the rules to its
    cells."""
    status, inc, present, has_change, pcount, pending, deadline = (p.reshape(-1) for p in planes)
    c_flat = cand.reshape(-1)
    n = cand.shape[0]
    cells = n * n
    groups = -(-cells // 4)
    seen = np.zeros(groups, np.int64)
    stats = {"straddles": 0, "diagonal": 0} if stats is None else stats
    for b in range(f1_blocks(n)):
        for t in range(F1_THREADS):
            first = 4 * (b * F1_THREADS + t)
            if first >= cells:
                continue
            seen[first // 4] += 1
            c = [int(c_flat[first + k]) if first + k < cells else -1 for k in range(4)]
            if max(c) < 0:
                continue
            i0 = _quotient(first, n)
            assert i0 == first // n
            j0 = first - i0 * n
            for k in range(4):
                if c[k] < 0:
                    continue
                i, j = i0, j0 + k
                if j >= n:
                    j, i = j - n, i + 1
                assert (i, j) == divmod(first + k, n)
                stats["straddles"] += i != i0
                stats["diagonal"] += i == j
                at = first + k
                cell = (int(status[at]), int(pending[at]), int(inc[at]), bool(present[at]))
                applied, schedule, (st, pe, ic, pr) = _rules(c[k], i == j, cell, now)
                if not applied:
                    continue
                status[at], pending[at], inc[at], present[at] = st, pe, ic, pr
                has_change[at], pcount[at] = True, 0
                if schedule:
                    deadline[at] = _as_i32(tick + timeouts[st - 1 if st < 4 else 2])
    assert (seen == 1).all()
    return stats


def _state_and_batch(n, density, seed, tick=37):
    """A random state (every status, pending -1..4, ties, absent cells) and a
    candidate batch near each cell's own incarnation (wins, losses,
    refutations, first-seen tombstones)."""
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, 6, (n, n)).astype(np.int32) * 200
    planes = [rng.integers(0, 5, (n, n)).astype(np.int8), inc, rng.random((n, n)) < 0.7,
              rng.random((n, n)) < 0.4, rng.integers(0, 40, (n, n)).astype(np.int32),
              rng.integers(-1, 5, (n, n)).astype(np.int8), rng.integers(tick - 5, tick + 30, (n, n)).astype(np.int32)]
    cand_inc = np.maximum(inc + rng.integers(-1, 2, (n, n)).astype(np.int32) * 200, 0)
    cand = np.where(rng.random((n, n)) < density, (cand_inc << 3) | rng.integers(0, 5, (n, n)), -1).astype(np.int32)
    np.fill_diagonal(cand, np.where(rng.random(n) < density, (np.diag(inc) << 3) | 1, -1))  # refutations
    return planes, cand


def _plain(planes, cand, tick, now, timeouts):
    t = [torch.as_tensor(p.copy()) for p in planes]
    fk.apply_plain(t, torch.as_tensor(cand), torch.tensor(tick, dtype=torch.int32),
                   torch.tensor(now, dtype=torch.int32), timeouts)
    return [x.numpy() for x in t]


@pytest.mark.parametrize("density", [0.01, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 31, 33])
def test_f1_decomposition_matches_plain(n, density):
    planes, cand = _state_and_batch(n, density, 100 * n + int(10 * density))
    want = _plain(planes, cand, 37, 7400, (5, 20, 6))
    got = [p.copy() for p in planes]
    stats = f1_emulate(got, cand, 37, 7400, (5, 20, 6))
    for name, a, b in zip(tfv.PLANES, want, got):
        assert np.array_equal(a, b), (name, np.argwhere(a != b)[:4].tolist())
    if n % 4 and n > 4 and density > 0.1:
        assert stats["straddles"] > 0 and stats["diagonal"] > 0, stats


@pytest.mark.parametrize("n", [1, 3, 131, 1000, 4097, fk.MAX_N])
def test_f1_grid_covers_each_group_once_without_wrapping(n):
    """The grid's threads take groups 0, 1, ... in order, so each group
    once; the last thread's first cell, and a group's end, stay below 2**32
    at every N up to MAX_N (the kernel's index is uint32)."""
    cells, blocks = n * n, f1_blocks(n)
    groups = -(-cells // 4)
    assert (blocks - 1) * F1_THREADS < groups <= blocks * F1_THREADS
    assert 4 * (blocks * F1_THREADS - 1) + 4 < 2**32
    if cells <= 2**20:
        first = 4 * (np.arange(blocks)[:, None] * F1_THREADS + np.arange(F1_THREADS))
        assert np.array_equal(first[first < cells] // 4, np.arange(groups))


def test_f1_reciprocal_rows_at_every_cell_of_the_largest_planes():
    """The quotient is each group's row for N up to MAX_N, at the group
    starts around each row end and at the plane's last group."""
    for n in (1, 2, 3, 7, 1000, 4097, 65521, fk.MAX_N):
        firsts = {0, 4 * ((n * n - 1) // 4)}
        for i in np.linspace(0, n - 1, 64).astype(np.int64).tolist():
            firsts |= {f for f in range(4 * ((i * n) // 4) - 8, 4 * ((i * n) // 4) + 12, 4) if 0 <= f < n * n}
        for first in firsts:
            assert _quotient(first, n) == first // n, (n, first)
    assert fk.MAX_N ** 2 < 2**32 <= (fk.MAX_N + 1) ** 2


def test_f1_every_leg_of_the_engine_tick(monkeypatch):
    """The five applications of each tick of a CPU engine (request, response,
    reverse full sync, suspect, timers) at N = 13 with crashes and loss,
    emulated, against the plain version on the same inputs."""
    calls = []
    plain = fk.apply_plain

    def record(planes, cand, tick, now, timeouts):
        calls.append(([p.numpy().copy() for p in planes], cand.numpy().copy(), int(tick), int(now), timeouts))
        plain(planes, cand, tick, now, timeouts)

    n = 13
    up = torch.ones(n, dtype=torch.bool)
    up[[2, 9]] = False
    sim = tfv.FullViewSim(n=n, seed=3, device="cpu", suspect_ticks=3)
    monkeypatch.setattr(fk, "apply", record)
    for _ in range(12):
        sim.tick(tfv.Faults(up=up, drop_rate=0.2))
    assert len(calls) == 5 * 12
    with_cands = 0
    for i, (planes, cand, tick, now, timeouts) in enumerate(calls):
        want = _plain(planes, cand, tick, now, timeouts)
        got = [p.copy() for p in planes]
        f1_emulate(got, cand, tick, now, timeouts)
        assert all(np.array_equal(a, b) for a, b in zip(want, got)), ("leg", i % 5, "tick", i // 5)
        with_cands += bool((cand >= 0).any())
    assert with_cands >= 20


def _cpu_planes(n):
    return [t.clone() for t in tfv.init_state(tfv.FullViewParams(n=n), device="cpu")[:7]]


def _shifted(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``'s values in a tensor whose base is ``nbytes`` past an aligned one."""
    raw = torch.zeros(t.numel() * t.element_size() + 64, dtype=torch.uint8)
    start = (-raw.data_ptr()) % 64 + nbytes
    out = raw[start:start + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("plane,nbytes,align", [(0, 1, 4), (2, 2, 4), (5, 3, 4), (1, 4, 16), (4, 8, 16),
                                                 (6, 12, 16), (7, 4, 16)])
def test_f1_launcher_refuses_planes_its_word_loads_cannot_take(plane, nbytes, align, monkeypatch):
    """Byte planes whose base is not 4-byte aligned, int32 planes (and the
    candidates, index 7) not 16-byte aligned, are refused with the reason;
    aligned ones pass."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    n = 9
    tensors = _cpu_planes(n) + [torch.full((n, n), -1, dtype=torch.int32)]
    tick = torch.tensor(3, dtype=torch.int32)
    aligned = [_shifted(t, 0) for t in tensors]
    assert fk._check(aligned[:7], aligned[7], tick, tick) == n
    aligned[plane] = _shifted(tensors[plane], nbytes)
    with pytest.raises(ValueError, match=f"{align}-byte aligned"):
        fk._check(aligned[:7], aligned[7], tick, tick)


def test_f1_launcher_refuses_planes_past_the_quotient(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    n = fk.MAX_N + 1
    planes = [torch.empty((n, n), dtype=d, device="meta") for d in fk.PLANE_DTYPES]
    tick = torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="N <= 65535"):
        fk._check(planes, torch.empty((n, n), dtype=torch.int32, device="meta"), tick, tick)
