"""Kernels D1 and R1's decompositions, emulated on the CPU.

D1 (``csrc/telemetry.cu`` ``telemetry_state_digest``, the state digest)
and R1 (``telemetry_sum_windows`` and ``telemetry_sum_levels``, the
record's float32 sums) run only on the card.  Their index arithmetic is
emulated here in numpy, step for step as the kernels and their host
functions take it, with the block sizes, vector bytes and window read from
the source, and held to the plain versions (``sim/telemetry.py``:
``leaf_digest_sum_plain``, ``f32_sum_plain``), which
``tests/test_torch_telemetry.py`` holds to the JAX package:

* D1: a leaf's head (the elements before its first 16-byte boundary), its
  body of 16-byte vectors and its tail, for every leaf kind of phase 14a's
  leaf sets at every base 0..15 bytes past alignment, at flat-index
  offsets that wrap; the leaf's blocks (one wave over the state, in
  proportion to the elements) walking the body grid-stride with its
  vectors in flight; every element visited once, with the flat index
  ``offset + i`` mod 2**32 that JAX's ``flat_index_u32`` gives; the aligned
  chunk's shared first step (``b ^ j``), the seam of the two mixes (their
  shifts by 16 cancel, so an element enters as w = v ^ v >> 16: for int8
  and bool bytes one byte permute of its word and of the word xored with
  its bytes' signs);
* R1: a thread a first-level window (its slices, lanes and padding), a
  block an input's upper levels, over the shapes phase 14a checks on the
  card.

The tolerance is none.
"""

import re
import zlib

import numpy as np
import pytest
import torch

from ringpop_tpu_torch.ops import telemetry_kernel as tk
from ringpop_tpu_torch.sim import telemetry as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


M32 = 0xFFFFFFFF
SMS = 132  # an H100 SXM's SMs: the grid's wave


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", tk.SOURCE.read_text()).group(1))


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\w+)", tk.SOURCE.read_text()).group(1), 0)


THREADS = _constant("kThreads")
BLOCKS_PER_SM = _constant("kBlocksPerSm")
VEC_BYTES = _constant("kVecBytes")
UNROLL = _macro("RP_D1_UNROLL")
WINDOW = _constant("kSumWindow")
SIZES = {"bool": 1, "int8": 1, "int32": 4, "int64": 8}


def _mix32(x):
    x = x.astype(np.uint64)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x


def _digest_from(h, w):
    """``digest_from``: mix32(v ^ mix32(idx)) from h = (idx ^ idx >> 16) * C1
    and w = v ^ v >> 16, the two mixes' shifts by 16 at their seam left
    out."""
    h = h.astype(np.uint64) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= w
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


def _byte_fold(word: np.ndarray, kind: str, b) -> np.ndarray:
    """``byte_fold``: w = v ^ v >> 16 of byte b (one for each word, or one
    for all) of 32-bit words, as the PRMT of q (the word xored with each
    byte's sign replicated) and the word takes it for int8, the byte
    zero-extended for bool."""
    word = word.astype(np.uint64)
    byte = (word >> (np.uint64(8) * np.asarray(b, np.uint64))) & 0xFF
    if kind == "bool":
        return byte
    sign = np.where(byte >= 0x80, np.uint64(0xFF), np.uint64(0))
    q_byte = byte ^ sign  # byte b of q: its top bit clear, so its replicated sign is 0
    assert (q_byte < 0x80).all()
    return q_byte | (sign << np.uint64(16)) | (sign << np.uint64(24))  # byte 1: q's byte's sign, 0


def _values(leaf: np.ndarray) -> np.ndarray:
    """Each element as uint32: bool 0/1, int8 sign-extended, int32 bits,
    int64 its low word."""
    return leaf.reshape(-1).astype(np.int64).astype(np.uint64) & M32


def _plan(leaves: list, addrs: list, offsets: list) -> list:
    """``rp_state_digest``'s table: each leaf's head, vectors, alignment and
    blocks, from its kind, element count and base address."""
    elements = sum(x.size for x, _ in leaves)
    wave = BLOCKS_PER_SM * SMS
    out, block0 = [], 0
    for (x, kind), addr, offset in zip(leaves, addrs, offsets):
        n, size = x.size, SIZES[kind]
        assert addr % size == 0
        head, vecs, per, aligned = 0, 0, 1, False
        if kind != "int64":
            per = VEC_BYTES // size
            head = min((VEC_BYTES - addr % VEC_BYTES) % VEC_BYTES // size, n)
            vecs = (n - head) // per
            aligned = (offset + head) % per == 0
        items = n if kind == "int64" else vecs + (n - vecs * per)
        want = -(-items // (THREADS * UNROLL))
        share = -(-(wave * n) // elements) if elements else 1
        blocks = max(1, min(want, share))
        out.append(dict(n=n, head=head, vecs=vecs, per=per, aligned=aligned, block0=block0, blocks=blocks,
                        offset=offset, kind=kind))
        block0 += blocks
    return out


def _walk(lf: dict):
    """Every (element, flat index, first product) the leaf's blocks visit:
    the head and tail element by element a thread every ``stride``, the
    body's vectors ``UNROLL`` in flight then one at a time, as
    ``leaf_partial`` / ``scalar_partial`` take them."""
    stride = lf["blocks"] * THREADS
    first = np.arange(stride, dtype=np.int64)
    offset = lf["offset"]
    elems, idxs, prods = [], [], []

    def scalar(lo, hi):
        for start in range(lo, hi, stride):
            i = start + first[: max(0, min(stride, hi - start))]
            idx = (offset + i) & M32
            elems.append(i)
            idxs.append(idx)
            prods.append(((idx ^ (idx >> 16)) * 0x85EBCA6B) & M32)

    n, head, vecs, per = lf["n"], lf["head"], lf["vecs"], lf["per"]
    if lf["kind"] == "int64":
        scalar(0, n)
    else:
        scalar(0, head)
        scalar(head + vecs * per, n)
        idx_body = (offset + head) & M32
        visited = []
        v = first.copy()
        live = v + (UNROLL - 1) * stride < vecs
        while live.any():
            visited += [v[live] + u * stride for u in range(UNROLL)]
            v = np.where(live, v + UNROLL * stride, v)
            live = v + (UNROLL - 1) * stride < vecs
        live = v < vecs
        while live.any():
            visited.append(v[live])
            v = np.where(live, v + stride, v)
            live = v < vecs
        lane = np.arange(per, dtype=np.int64)
        for vec in visited:
            idx0 = ((idx_body + per * (vec & M32)) & M32)[:, None]  # the 32-bit lane: wrapping, once a vector
            idx = (idx0 + lane) & M32
            if lf["aligned"]:
                prod = (((idx0 ^ (idx0 >> 16)) ^ lane) * 0x85EBCA6B) & M32
            else:
                prod = ((idx ^ (idx >> 16)) * 0x85EBCA6B) & M32
            elems.append((head + vec[:, None] * per + lane).reshape(-1))
            idxs.append(idx.reshape(-1))
            prods.append(prod.reshape(-1))
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return cat(elems), cat(idxs), cat(prods)


def _words(leaf: np.ndarray) -> np.ndarray:
    """The little-endian 32-bit word whose first byte is byte e of the leaf,
    for every e (zeros past its end)."""
    raw = np.concatenate([leaf.reshape(-1).view(np.uint8), np.zeros(3, np.uint8)]).astype(np.uint64)
    n = raw.size - 3
    return raw[:n] | raw[1:n + 1] << np.uint64(8) | raw[2:n + 2] << np.uint64(16) | raw[3:] << np.uint64(24)


def _emulated_sum(leaf: np.ndarray, lf: dict, values=None, words=None) -> int:
    """The leaf's sum as the emulated walk takes it; ``values`` and
    ``words``, the leaf's ``_values`` and ``_words``, once a leaf."""
    elems, idxs, prods = _walk(lf)
    # every element once, with JAX's wrapping flat index and the first
    # product of its own index
    assert elems.size == lf["n"] and (np.bincount(elems, minlength=lf["n"]) == 1).all()
    assert np.array_equal(idxs.astype(np.uint64), (np.uint64(lf["offset"]) + elems.astype(np.uint64)) & M32)
    assert np.array_equal(prods, ((idxs ^ (idxs >> 16)) * 0x85EBCA6B) & M32)
    values = (_values(leaf) if values is None else values)[elems]
    folds = values ^ (values >> np.uint64(16))
    if lf["kind"] in ("int8", "bool"):
        # the body's elements by the byte permute of their 4-byte word (the
        # vectors start at the head, so byte k of a word is (e - head) % 4)
        in_body = (elems >= lf["head"]) & (elems < lf["head"] + lf["vecs"] * lf["per"])
        k = (elems[in_body] - lf["head"]) % 4
        word = (_words(leaf) if words is None else words)[elems[in_body] - k]
        folds[in_body] = _byte_fold(word, lf["kind"], k)
    return int(_digest_from(prods.astype(np.uint64), folds).sum() & M32)


def _leaf(rng, kind: str, shape):
    if kind == "bool":
        return rng.random(shape) < 0.5
    info = np.iinfo({"int8": np.int8, "int32": np.int32, "int64": np.int64}[kind])
    hi = 2**32 if kind == "int64" else int(info.max) + 1
    lo = 0 if kind == "int64" else info.min
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(info.dtype)


def _torch(leaf: np.ndarray):
    return torch.from_numpy(leaf.copy())


# phase 14a's leaf kinds and shapes (chip_smoke.digest_leaves) at N <= 4097
LEAF_SETS = [(kind, shape) for n in (1, 31, 33, 4097) for k in (40, 64, 256)
             for kind, shape in (("int32", (k,)), ("int8", (k,)), ("int32", (n, (k + 31) // 32)), ("int8", (n, k)),
                                 ("bool", (n,)), ("int8", (n,)), ("int64", (2,)), ("int32", ()))]
LEAF_SETS = sorted(set(LEAF_SETS), key=str)


@pytest.mark.parametrize("kind,shape", LEAF_SETS, ids=[f"{k}{list(s)}" for k, s in LEAF_SETS])
def test_d1_walk_visits_every_element_once_with_its_flat_index(kind, shape):
    rng = np.random.default_rng(zlib.crc32(f"{kind}{shape}".encode()))
    leaf = _leaf(rng, kind, shape)
    size = SIZES[kind]
    want = {}
    values, words = _values(leaf), (_words(leaf) if kind in ("int8", "bool") else None)
    for misalign in range(0, VEC_BYTES, size):
        # offset 0 (the tree digest's), an unaligned one, and two that wrap,
        # aligned and not; the large leaves at one that wraps (its chunks
        # aligned at base 13, unaligned at the others)
        offsets = (0, 5, 2**32 - 3, 2**32 - 16 * 3 - misalign) if leaf.size <= 1 << 16 else (2**32 - 3,)
        for offset in offsets:
            lf = _plan([(leaf, kind)], [4096 + misalign], [offset])[0]
            if kind != "int64":
                assert lf["head"] == min(leaf.size, (VEC_BYTES - misalign) % VEC_BYTES // size)
            if offset not in want:
                want[offset] = int(tt.leaf_digest_sum_plain(_torch(leaf), offset))
            assert _emulated_sum(leaf, lf, values, words) == want[offset], (misalign, offset)


def test_d1_blocks_follow_the_elements_over_a_whole_state():
    """A state's leaves share one wave of blocks in proportion to their
    elements (at least one each); the tree digest of the emulated walks is
    the plain tree digest."""
    rng = np.random.default_rng(11)
    leaves = [(_leaf(rng, kind, shape), kind) for kind, shape in (
        ("int32", ()), ("int32", (256,)), ("int8", (256,)), ("int32", (4097, 8)), ("int8", (4097, 256)),
        ("bool", (4097,)), ("int8", (4097,)), ("int64", (2,)))]
    addrs = [4096 * (i + 1) + (3 if kind in ("int8", "bool") else 0) for i, (_, kind) in enumerate(leaves)]
    plan = _plan(leaves, addrs, [0] * len(leaves))
    assert [p["block0"] for p in plan] == list(np.cumsum([0] + [p["blocks"] for p in plan])[:-1])
    assert min(p["blocks"] for p in plan) >= 1
    big = max(range(len(plan)), key=lambda i: plan[i]["n"])
    assert plan[big]["blocks"] == max(p["blocks"] for p in plan)
    acc = 0
    for li, ((leaf, _), lf) in enumerate(zip(leaves, plan)):
        s = _emulated_sum(leaf, lf)
        acc += int(_mix32(np.array([s ^ ((li * 0x9E3779B9) & M32)]))[0])
    assert acc & M32 == int(tt.tree_digest_plain([_torch(x) for x, _ in leaves]))


@pytest.mark.parametrize("c", [4, 16])
def test_d1_aligned_chunk_shares_the_first_step(c):
    """Within a chunk of c flat indices starting at a multiple of c (c = 4
    int32 or 16 int8 elements, a 16-byte vector), ``idx ^ idx >> 16`` is
    the chunk's first index's xored with the lane: the high half never
    changes inside the chunk; a chunk that starts off a multiple of c can
    straddle it, and is taken element by element instead."""
    rng = np.random.default_rng(5 + c)
    idx0 = (rng.integers(0, 2**32 // c, size=50_000, dtype=np.uint64) * c) & M32
    idx0 = np.concatenate([idx0, np.array([2**16 - c, 2**32 - c, 0], np.uint64)])
    b = idx0 ^ (idx0 >> 16)
    for j in range(c):
        idx = (idx0 + j) & M32
        assert np.array_equal(idx ^ (idx >> 16), b ^ j)
    idx = np.array([2**16 - 2], np.uint64)  # a chunk off its multiple straddles the high half
    assert ((idx + c - 1) >> 16) != (idx >> 16)


# -- R1 ------------------------------------------------------------------------


def _r1_plan(rows: int, lanes: int) -> dict:
    """``rp_f32_sums``' plan for one input: windows, front padding, rows in
    lanes."""
    windows = -(-rows // WINDOW)
    pad_lo = first = 0
    if rows > WINDOW and lanes != 0:
        pad = -rows % WINDOW
        pad_lo, first = pad // 2, (WINDOW - pad) // lanes * lanes
    if lanes > 1:
        assert rows > WINDOW and pad_lo == 0
    return dict(windows=windows, pad_lo=pad_lo, first=first)


def _r1_emulate(flat: np.ndarray, rows: int, width: int, ld: int, lanes: int) -> np.float32:
    """R1 on one input, its elements ``flat`` (rows of ``width`` words ``ld``
    apart, as float32; the int64 values when ``lanes`` is 0), as the staged
    kernels take it: ``staged_window_sum`` (a window's elements e in
    slices of WINDOW, its row e // width and column e % width loaded, 0 for
    a row of padding or past the end; the first ``first * width`` in
    lanes by a row counter, then the lanes halved, the rest in order) and
    ``float_levels`` (windows of WINDOW over a level, pad // 2 zeros in
    front and the rest behind, added; then the last values in order)."""
    plan = _r1_plan(rows, lanes)
    f32 = np.float32
    if lanes == 0:  # exact, rounded once
        return f32(sum(int(flat[r * ld + c]) for r in range(rows) for c in range(width)))
    level = np.zeros(plan["windows"], f32)
    in_lanes = plan["first"] * width if lanes > 1 else 0
    for w in range(plan["windows"]):
        r0 = w * WINDOW - plan["pad_lo"]
        lane, acc, row, col = [f32(0)] * max(lanes, 1), f32(0), 0, 0
        for e0 in range(0, WINDOW * width, WINDOW):
            for j in range(WINDOW):
                e = e0 + j
                r = r0 + e // width
                x = flat[r * ld + e % width] if 0 <= r < rows else f32(0)
                if e < in_lanes:
                    lane[row % lanes] = f32(lane[row % lanes] + x)
                    if e == in_lanes - 1:
                        h = lanes // 2
                        while h:
                            lane = [f32(lane[ln] + lane[ln + h]) for ln in range(h)] + lane[h:]
                            h //= 2
                        acc = lane[0]
                else:
                    acc = f32(acc + x)
                col += 1
                if col == width:
                    col, row = 0, row + 1
        level[w] = acc
    m = plan["windows"]
    while m > WINDOW:
        pad = (WINDOW - m % WINDOW) % WINDOW
        lo, nxt = pad // 2, (m + pad) // WINDOW
        up = np.zeros(nxt, f32)
        for j in range(nxt):
            acc = f32(0)
            for q in range(WINDOW):
                i = j * WINDOW + q - lo
                acc = f32(acc + (level[i] if 0 <= i < m else f32(0)))
            up[j] = acc
        level, m = up, nxt
    acc = f32(0)
    for i in range(WINDOW):
        acc = f32(acc + (level[i] if i < m else f32(0)))
    return acc


R1_SHAPES = [(n, w) for n in (1, 31, 33, 63, 1023, 4097) for w in (1, 2, 8)] + [(2048, 3), (1024, 7), (2047, 5)]


@pytest.mark.parametrize("n,w", R1_SHAPES)
def test_r1_windows_and_levels_match_the_plain_sum(n, w):
    rng = np.random.default_rng(n * 10 + w)
    x = rng.integers(2**24, 2**28, size=(n, w)).astype(np.int32)
    lanes = tt.sum_lanes(n, w)
    flat = x.reshape(-1)
    got = _r1_emulate(flat.astype(np.float32) if lanes else flat.astype(np.int64), n, w, w, lanes)
    want = tt.f32_sum_plain(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes(), (lanes, got, want)
    # a column of an [N, 4] plane: rows 4 apart, in order
    cols = rng.integers(2**24, 2**28, size=(n, 4)).astype(np.int32)
    flat = cols.astype(np.float32).reshape(-1)
    got = [_r1_emulate(flat[c:], n, 1, 4, 1) for c in range(4)]
    want = tt.f32_sum_plain(torch.from_numpy(cols), by_column=True).numpy()
    assert np.array(got, np.float32).tobytes() == want.tobytes()


def test_r1_refuses_what_it_does_not_take_on_the_cpu():
    """The launcher takes CUDA tensors only (the plain version is the CPU's
    path, chosen by ``f32_sums``)."""
    with pytest.raises(ValueError):
        tk.f32_sums_cuda([(torch.zeros(4, dtype=torch.int32), False, False, 1)])
