"""A plain model of how the tile loop (K1 `pack_raw`, K2 `pack_pairs`, B2
`pack_fused4` and its checked form), K3 (`pack_windows`) and K4
(`pack_split`) cut a row, held against the twins
`cuda_pack.pack_raw_plain`, `pack_pairs_plain` and `pack_fused4_plain`.

The CUDA kernels (`csrc/pack_fused4.cu`, `csrc/pack_split.cu`) cannot run
on the CPU, so this file rehearses their decomposition with small tiles
(8 to 64 codes, and a "warp" of 2 to 8 lanes) so that tile boundaries come
often, and at the kernels' own geometries:

* The tile loop (`model_tiles`): one block per row; a tile is `threads` x
  V slots, thread tid holding the V consecutive slots tid V .. tid V + V -
  1 of it, loaded together (whole groups of 4, or of 2 when V is not a
  multiple of 4, with vector loads when the row's length allows, else one
  by one; slots past the row read as length 0); the loads of tile t + 1
  go out before tile t's barrier; per tile a "warp" scan of the thread
  sums, the warp totals in one half of a double buffer, each thread's
  offset from its warp's prefix and the running carry, which every thread
  keeps; its slots placed one after another from there; nbits is the
  final carry.  The sources: K1's raw codes, each in a 64-bit window;
  K2's pairs (0, 1), (2, 3) of a thread's codes fused as `_fuse2_32` does
  and placed from a 96-bit window (an odd K's last code paired with one
  past the row); B2's fused slots, loaded whole, from a 160-bit window.
  B2's checked form counts
  lengths outside [0, 128] and placements onto set bits, and skips a
  value that starts above its window.  Mutations (no carry, an inclusive
  offset, the next tile loaded after the barrier, a pair fused in the
  wrong order, the checked skip dropped) each fail.

* K4: per-tile totals; each tile's first bit from a decoupled look-back
  over its predecessors' status words (aggregate or inclusive prefix,
  chosen at random as a run would leave them), read a warp at a time;
  placement into a window of tile + 1 words; the words only the tile
  touches stored plainly, its first and last words ORed into a zeroed
  row; the row's last tile writes the bit count.  The model checks that
  no word stored plainly is touched by any other tile.
* K3: level-1 chunk totals; per chunk its first bit and whether it holds
  the row's last bit; the words it owns (their last bit is its own),
  stored once, with their leading bits read back from the codes before
  it, a warp at a time, over zero-length runs and whole empty chunks;
  the zero tail and the bit count from the last chunk with bits (chunk 0
  of an empty row), the words before the bit offset from chunk 0.  The
  model checks that every word of the buffer is stored exactly once.

The cases are the kernels' edge cases: empty, 1-bit and 32-bit lengths,
long zero-length runs across tiles, words that take bits from three
tiles, rows shorter than a tile or empty, one code short of a tile, a
whole tile, one code past it, K % 4 != 0, buffers that end inside a tile,
at a tile's first word, exactly at the used words, overflow, or are the
342,528 B buffer that the tile loop keeps in global memory; for B2 the same
rows as fused slots of up to 128 bits, and for its checked form lengths of
200 and 129 at a tile's first and last slot and negative ones.
Tolerance: exact (0); the checked form's overlap count as zero / nonzero
where a negative length makes slots overlap.  Nothing in the port imports
this model.
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.ops import bitpack, cuda_pack

M32 = 0xFFFFFFFF


def _place(code: int, length: int, off: int):
    """`place_words`: the code's two words from word off >> 5 on."""
    sh = 64 - (off & 31) - length
    if sh >= 32:
        return (code << (sh - 32)) & M32, 0
    return code >> (32 - sh), (code << sh) & M32


def _tiles(k: int, size: int) -> int:
    return -(-k // size) if k > size else 1


def _window(c, ln, i0: int, i1: int, start: int, nwin: int):
    """The words from word start >> 5 on that codes i0..i1-1 fill, their
    first bit at `start`; codes of length 1..32 only."""
    win = [0] * nwin
    wbase, off = start >> 5, start
    for i in range(i0, i1):
        if 1 <= ln[i] <= 32:
            w0, w1 = _place(c[i], ln[i], off)
            lw = (off >> 5) - wbase
            for w, v in ((lw, w0), (lw + 1, w1)):
                if v and 0 <= w < nwin:
                    win[w] |= v
        off += ln[i]
    return win


def _look_back(status, t: int, lanes: int) -> int:
    """K4's look-back: tile t's first bit from the status words (flag,
    value) of tiles < t, `lanes` at a time; the prefixes count from bit 0
    of the row, so tile 0's holds the bit offset."""
    prefix, j = 0, t - 1
    while True:
        window = [status[j - q] if j - q >= 0 else ("P", 0) for q in range(lanes)]
        ps = [q for q, (flag, _) in enumerate(window) if flag == "P"]
        stop = ps[0] if ps else lanes
        prefix += sum(v for q, (_, v) in enumerate(window) if q <= stop)
        if ps:
            return prefix
        j -= lanes


def model_split(codes, lens, max_words: int, bit_offset: int, tile: int, lanes: int, rng):
    n, k = lens.shape
    nt = _tiles(k, tile)
    out = np.zeros((n, max_words), np.int64)
    plain = np.zeros((n, max_words), np.int64)
    ored = np.zeros((n, max_words), np.int64)
    nbits = np.zeros(n, np.int64)
    for r in range(n):
        c = [int(x) & M32 for x in codes[r]]
        ln = [int(x) for x in lens[r]]
        totals = [sum(ln[t * tile:(t + 1) * tile]) for t in range(nt)]
        incl = np.cumsum([bit_offset + totals[0], *totals[1:]]).tolist()
        for t in range(nt):
            # what tile t may see: every predecessor has published its
            # total; some (tile 0 always) their inclusive prefix
            status = [("P", incl[j]) if j == 0 or rng.random() < 0.5 else ("A", totals[j])
                      for j in range(t)]
            start = bit_offset if t == 0 else _look_back(status, t, lanes)
            assert start == incl[t] - totals[t]
            end = start + totals[t]
            if t == nt - 1:
                nbits[r] = end
            win = _window(c, ln, t * tile, min((t + 1) * tile, k), start, tile + 1)
            if end <= start:
                continue
            wbase = start >> 5
            wl = min((end - 1) >> 5, wbase + tile)
            for w in {wbase, wl}:  # the edge words: atomicOr
                if 0 <= w < max_words:
                    out[r, w] |= win[w - wbase]
                    ored[r, w] += 1
            for w in range(max(wbase + 1, 0), min(wl, max_words)):
                out[r, w] = win[w - wbase]
                plain[r, w] += 1
    assert plain.max(initial=0) <= 1 and not ((plain > 0) & (ored > 0)).any()
    return out, nbits


def _back_bits(c, ln, totals, i0: int, start: int, lo: int, chunk: int, lanes: int):
    """K3's backward read: the bits that codes before i0 place into word
    start >> 5 from bit lo on."""
    need, wf = start - lo, start >> 5
    acc = done = 0
    j = i0 - 1
    while done < need and j >= 0:
        while j >= 0 and totals[j // chunk] == 0:
            j = j // chunk * chunk - 1
        if j < 0:
            break
        incl = 0
        for q in range(lanes):
            i = j - q
            length = ln[i] if i >= 0 else 0
            incl += length
            if 1 <= length <= 32:
                off = start - done - incl
                w0, w1 = _place(c[i], length, off)
                if off >> 5 == wf:
                    acc |= w0
                elif (off >> 5) + 1 == wf:
                    acc |= w1
        done += incl
        j -= lanes
    return acc


def model_windows(codes, lens, max_words: int, bit_offset: int, chunk: int, lanes: int, rng=None):
    n, k = lens.shape
    nch = _tiles(k, chunk)
    out = np.zeros((n, max_words), np.int64)
    stores = np.zeros((n, max_words), np.int64)
    nbits = np.full(n, -1, np.int64)
    for r in range(n):
        c = [int(x) & M32 for x in codes[r]]
        ln = [int(x) for x in lens[r]]
        totals = [sum(ln[h * chunk:(h + 1) * chunk]) for h in range(nch)]  # level 1
        for h in range(nch):
            total, after = totals[h], sum(totals[h + 1:])
            start = bit_offset + sum(totals[:h])
            end = start + total
            tail = after == 0 and (total != 0 or h == 0)
            if tail:
                assert nbits[r] == -1
                nbits[r] = end
            back = _back_bits(c, ln, totals, h * chunk, start, max(start & ~31, bit_offset),
                              chunk, lanes)
            win = _window(c, ln, h * chunk, min((h + 1) * chunk, k), start, chunk + 1)
            wbase = start >> 5
            a = 0 if h == 0 else wbase
            b = min(max_words if tail else end >> 5, max_words)
            for w in range(max(a, 0), b):
                lw = w - wbase
                v = win[lw] if 0 <= lw < chunk + 1 else 0
                out[r, w] = v | back if lw == 0 else v
                stores[r, w] += 1
    assert (stores == 1).all(), "every word is stored exactly once"
    return out, nbits


def _window_words(u, nw: int, length: int, off: int, skip: bool):
    """`place_window`: [(word, value)] of a value of `length` bits, words
    u[1..nw] (most significant first) below u[0] = 0, at bit offset off,
    from the top of its 32 (nw + 1)-bit window; `skip`: nothing when the
    value would start above the window (the checked form)."""
    sig = 32 * (nw + 1) - (off & 31) - length
    if length <= 0 or (skip and sig < 0):
        return []
    q, r = sig >> 5, sig & 31
    out = []
    for j in range(nw + 1):
        i = j + q
        hi = u[i] if 0 <= i <= nw else 0
        lo = u[i + 1] if 0 <= i + 1 <= nw else 0
        out.append(((off >> 5) + j, ((hi << r) | (lo >> (32 - r))) & M32 if r else hi))
    return out


def _fuse_pair(c1: int, l1: int, c2: int, l2: int):
    """`_fuse2_32` of one pair: (hi, lo) of c1 2^l2 | c2."""
    c1, c2 = (c1 if l1 > 0 else 0), (c2 if l2 > 0 else 0)
    r = l2 & 31
    hi = (c1 >> (32 - r) if r else c1) if l2 > 0 else 0
    lo = ((c1 << r) & M32 if l2 < 32 else 0) | c2
    return hi, lo


def model_tiles(source: str, arrays, max_words: int, bit_offset: int, threads: int, v: int,
                lanes: int, checks: bool = False, mutation=None):
    """The tile loop, the order of its steps kept per tile: K1 (source
    "raw", arrays (codes, lens)), K2 ("pairs", the same arrays) or B2
    ("fused4", arrays (v0, v1, v2, v3, flens); `checks` its checked form)
    -> (words, nbits, viol)."""
    lens_all = arrays[-1]
    n, k = lens_all.shape
    warps, tile = threads // lanes, threads * v
    width = 4 if v % 4 == 0 else 2
    vec = k % width == 0
    ntiles = -(-k // tile)
    tid = np.arange(threads)
    out = np.zeros((n, max_words), np.int64)
    nbits = np.zeros(n, np.int64)
    viol = np.zeros(n, np.int64)
    for r in range(n):
        ln = lens_all[r].astype(np.int64)
        planes = [a[r].astype(np.int64) & M32 for a in arrays[:-1]]
        events = []

        def read(arr, t):
            i = t * tile + v * tid[:, None] + np.arange(v)  # (threads, v)
            inside = i < k
            if vec:  # vector loads: a group of `width` is read whole or not at all
                group = i - np.arange(v) % width
                assert np.array_equal(group < k, inside)
            j = np.minimum(i, max(k - 1, 0))
            return np.where(inside, arr[j] if k else 0, 0)

        def load(t):  # tile t's lengths and words
            events.append(("load", t))
            return read(ln, t), [read(p, t) for p in planes]

        cur_l, cur_w = load(0)
        carry = bit_offset
        hits = 0
        s_warp = np.zeros((2, warps), np.int64)
        for t in range(ntiles):
            if mutation != "load-after-barrier":
                nxt = load(t + 1)
            sums = cur_l.sum(axis=1)
            incl = sums.reshape(warps, lanes).cumsum(axis=1).reshape(-1)
            s_warp[t & 1] = incl.reshape(warps, lanes)[:, -1]
            events.append(("barrier", t))
            if mutation == "load-after-barrier":
                nxt = load(t + 1)
            before = np.concatenate([[0], np.cumsum(s_warp[t & 1])[:-1]])[tid // lanes]
            off = before + (incl if mutation == "inclusive-offset" else incl - sums)
            if mutation != "no-carry":
                off = off + carry
            carry += int(s_warp[t & 1].sum())
            for th in range(threads):
                o = int(off[th])
                ls = [int(x) for x in cur_l[th]]
                ws = [[int(p[th, e]) for p in cur_w] for e in range(v)]
                if source == "raw":
                    for e in range(v):
                        if ls[e] > 0:
                            w0, w1 = _place(ws[e][0], ls[e], o)
                            for w, val in ((o >> 5, w0), ((o >> 5) + 1, w1)):
                                if val and 0 <= w < max_words:
                                    out[r, w] |= val
                        o += ls[e]
                    continue
                for e in range(0, v, 2 if source == "pairs" else 1):
                    if source == "pairs":
                        a, b = (e + 1, e) if mutation == "pair-order" else (e, e + 1)
                        u = [0, *_fuse_pair(ws[a][0], ls[a], ws[b][0], ls[b])]
                        length, nw = ls[a] + ls[b], 2
                    else:
                        u, length, nw = [0, *ws[e]], ls[e], 4
                        hits += checks and (length < 0 or length > 128)
                    skip = checks and mutation != "no-checked-skip"
                    for w, val in _window_words(u, nw, length, o, skip):
                        if val and 0 <= w < max_words:
                            hits += checks and (int(out[r, w]) & val) != 0
                            out[r, w] |= val
                    o += length
            cur_l, cur_w = nxt
        nbits[r], viol[r] = carry, hits
        for t in range(ntiles):  # tile t + 1 in flight across tile t's barrier
            assert events.index(("load", t + 1)) < events.index(("barrier", t)), "prefetch order"
    return out, nbits, viol


MODELS = {"K4": model_split, "K3": model_windows}
GEOMETRIES = [(8, 4), (32, 8)]  # (codes per tile or chunk, lanes of the "warp")


def _lengths(rng, n: int, k: int, content: str, tile: int):
    if content == "random":
        ln = rng.integers(0, 33, (n, k))
        ln[rng.random((n, k)) < 0.4] = 0
    elif content == "zeros":
        ln = np.zeros((n, k), np.int64)
    elif content == "ones":
        ln = np.ones((n, k), np.int64)
    elif content == "all32":
        ln = np.full((n, k), 32)
    elif content == "tiny":  # several tiles end inside one word
        ln = rng.integers(0, 3, (n, k))
    elif content == "zero-runs":  # runs of empty codes across tile boundaries
        ln = rng.integers(1, 33, (n, k))
        for r in range(n):
            for s in rng.integers(0, max(k, 1), 3):
                ln[r, s:s + int(rng.integers(tile // 2, 3 * tile))] = 0
    else:
        raise ValueError(content)
    return ln.astype(np.int32)


def _raw(seed: int, n: int, k: int, content: str, tile: int):
    rng = np.random.default_rng(seed)
    lens = _lengths(rng, n, k, content, tile)
    mask = (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    codes = (rng.integers(0, 1 << 32, (n, k), dtype=np.uint64) & mask).astype(np.uint32)
    return codes.view(np.int32), lens


def _used_words(lens, bit_offset: int) -> int:
    return int(-(-(bit_offset + lens.sum(axis=1, dtype=np.int64).max()) // 32))


# (content, n, k as a number or relative to the tile, max_words: a number,
# "used" (the longest row's words) or "tile2" (the first word of tile 2 of
# row 0), bit offset)
CASES = {
    "random": ("random", 3, 100, 1000, 38),
    "random-overflow": ("random", 2, 257, 7, 38),
    "random-used": ("random", 3, 257, "used", 38),
    "random-ends-at-tile2": ("random", 2, 257, "tile2", 38),
    "random-offset0": ("random", 2, 131, 600, 0),
    "random-offset32": ("random", 2, 131, 600, 32),
    "zeros": ("zeros", 2, 100, 20, 38),
    "ones": ("ones", 2, 257, "used", 38),
    "ones-offset31": ("ones", 1, 300, 40, 31),
    "all32": ("all32", 2, 100, 1000, 38),
    "all32-overflow": ("all32", 2, 100, 37, 38),
    "tiny": ("tiny", 3, 257, "used", 38),
    "zero-runs": ("zero-runs", 3, 257, 1000, 38),
    "zero-runs-used": ("zero-runs", 3, 300, "used", 5),
    "k0": ("random", 2, 0, 9, 38),
    "k1": ("random", 2, 1, 9, 38),
    "k-below-tile": ("random", 2, "tile-1", 30, 38),
    "k-one-tile": ("all32", 2, "tile", "used", 38),
    "k-above-tile": ("random", 2, "tile+1", 40, 38),
    "random-global-buffer": ("random", 2, 257, 342528 // 4, 38),
}
# K1 and K2: (threads, consecutive codes per thread, lanes of a "warp");
# the last is the kernels' own (128 threads x 4 codes, warps of 32)
K1_GEOMETRIES = [(8, 4, 4), (4, 8, 2), (16, 4, 8)]
K2_GEOMETRIES = [*K1_GEOMETRIES, (128, 4, 32)]
K1_MUTATIONS = ("no-carry", "inclusive-offset", "load-after-barrier")
# B2: (threads, consecutive fused slots per thread, lanes); small ones, three
# that were timed on the card (64 x 4, 128 x 4, 256 x 2) and the kernel's own
B2_GEOMETRIES = [(4, 2, 2), (8, 4, 4), (64, 4, 32), (128, 4, 32), (256, 2, 32), (512, 4, 32)]
# each must fail: K2 fusing (c2, c1) for (c1, c2); the checked B2 placing a
# value that starts above its window; B2 loading tile t + 1 after tile t's
# barrier
TILE_MUTATIONS = ("pair-order", "no-checked-skip", "load-after-barrier")


def _case(case: str, tile: int, fused: bool = False):
    """-> (arrays, max_words, bit_offset) of a case at this tile size:
    arrays (codes, lens) of raw codes, or with `fused` (v0, v1, v2, v3,
    flens) of 4:1-fused slots whose lengths are the raw case's times 4 (up
    to 128; "ones" and "tiny" keep theirs), each value masked to its
    length."""
    content, n, k, max_words, bit_offset = CASES[case]
    if isinstance(k, str):
        k = tile + {"tile-1": -1, "tile": 0, "tile+1": 1}[k]
    codes, lens = _raw(len(case) + 7 * tile, n, k, content, tile)
    arrays = (codes, lens)
    if fused:
        if content not in ("ones", "tiny"):
            lens = lens * 4
        rng = np.random.default_rng(len(case) + 11 * tile)
        words = rng.integers(0, 1 << 32, (4, n, k), dtype=np.uint64)
        for i in range(4):  # v0 holds the top bits
            keep = np.clip(lens - 32 * (3 - i), 0, 32).astype(np.uint64)
            words[i] &= (np.uint64(1) << keep) - np.uint64(1)
        arrays = (*words.astype(np.uint32).view(np.int32), lens)
    if max_words == "used":
        max_words = max(_used_words(lens, bit_offset), 1)
    elif max_words == "tile2":
        max_words = (bit_offset + int(lens[0, :2 * tile].sum())) >> 5
    return arrays, max_words, bit_offset


TWINS = {"raw": cuda_pack.pack_raw_plain, "pairs": cuda_pack.pack_pairs_plain}


def _twin(source: str, arrays, max_words: int, bit_offset: int, checks: bool = False):
    """The kernel's plain twin -> (seg, nbits, viol or None)."""
    ts = [torch.from_numpy(a) for a in arrays]
    if source == "fused4":
        out = cuda_pack.pack_fused4_plain(*ts, max_words, bit_offset, checks=checks)
        return out if checks else (*out, None)
    return (*TWINS[source](*ts, max_words, bit_offset), None)


def _matches(got, want) -> bool:
    words, nbits, viol = got
    return (np.array_equal(nbits, want[1].numpy())
            and torch.equal(bitpack.words_to_bytes(torch.from_numpy(words)), want[0])
            and (want[2] is None or np.array_equal(viol, want[2].numpy())))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["tile8", "tile32"])
@pytest.mark.parametrize("kernel", list(MODELS))
def test_decomposition_matches_the_twin(kernel, geometry, case):
    tile, lanes = geometry
    (codes, lens), max_words, bit_offset = _case(case, tile)
    seg, nbits, _ = _twin("raw", (codes, lens), max_words, bit_offset)
    words, got_bits = MODELS[kernel](codes, lens, max_words, bit_offset, tile, lanes,
                                     np.random.default_rng(lens.shape[1]))
    assert np.array_equal(got_bits, nbits.numpy())
    assert torch.equal(bitpack.words_to_bytes(torch.from_numpy(words)), seg)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", K1_GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_k1_tiles_match_the_twin(geometry, case):
    threads, v, lanes = geometry
    arrays, max_words, bit_offset = _case(case, threads * v)
    got = model_tiles("raw", arrays, max_words, bit_offset, threads, v, lanes)
    assert _matches(got, _twin("raw", arrays, max_words, bit_offset))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", K2_GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_k2_tiles_match_the_twin(geometry, case):
    """K2's pairs, fused in registers after K1's loads (an odd k's last
    code paired with one past the row), against `pack_pairs_plain`."""
    threads, v, lanes = geometry
    arrays, max_words, bit_offset = _case(case, threads * v)
    got = model_tiles("pairs", arrays, max_words, bit_offset, threads, v, lanes)
    assert _matches(got, _twin("pairs", arrays, max_words, bit_offset))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("checks", [False, True], ids=["plain", "checked"])
@pytest.mark.parametrize("geometry", B2_GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_b2_tiles_match_the_twin(geometry, checks, case):
    """B2's fused slots, and its checked form with no violation, against
    `pack_fused4_plain`."""
    threads, v, lanes = geometry
    arrays, max_words, bit_offset = _case(case, threads * v, fused=True)
    got = model_tiles("fused4", arrays, max_words, bit_offset, threads, v, lanes, checks)
    assert _matches(got, _twin("fused4", arrays, max_words, bit_offset, checks))
    assert not got[2].any()


@pytest.mark.parametrize("geometry", B2_GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_b2_checked_model_counts_bad_lengths(geometry):
    """Fused lengths of 200 (skipped: above its window) at a tile's first
    slot and 129 (placed) at a tile's last: the twin's exact counts and
    bytes; a negative length: the twin's bit counts, and overlaps found
    in that row only."""
    threads, v, lanes = geometry
    tile = threads * v
    arrays, _, bit_offset = _case("k-above-tile", tile, fused=True)
    max_words = 342528 // 4
    k = arrays[-1].shape[1]
    bad = [a.copy() for a in arrays]
    bad[4][0, tile] = 200
    bad[4][1, tile - 1] = 129
    for a in bad[:4]:  # every bit set: the skipped value would write, the other fits
        a[0, tile] = a[1, tile - 1] = -1
    got = model_tiles("fused4", bad, max_words, bit_offset, threads, v, lanes, True)
    assert _matches(got, _twin("fused4", bad, max_words, bit_offset, True))
    assert got[2].tolist() == [1, 1]
    neg = [a.copy() for a in arrays]
    neg[4][1, k // 2] = -7
    got = model_tiles("fused4", neg, max_words, bit_offset, threads, v, lanes, True)
    want = _twin("fused4", neg, max_words, bit_offset, True)
    assert np.array_equal(got[1], want[1].numpy())
    assert (got[2] > 0).tolist() == (want[2] > 0).tolist() == [False, True]


@pytest.mark.parametrize("mutation", K1_MUTATIONS)
def test_k1_mutated_models_fail(mutation):
    """Each mutation of K1's model either breaks the prefetch order or
    gives other bytes than the twin on rows of several tiles."""
    threads, v, lanes = K1_GEOMETRIES[0]
    arrays, max_words, bit_offset = _case("random", threads * v)
    try:
        got = model_tiles("raw", arrays, max_words, bit_offset, threads, v, lanes,
                          mutation=mutation)
    except AssertionError as e:
        assert "prefetch order" in str(e)
        return
    assert not _matches(got, _twin("raw", arrays, max_words, bit_offset))


@pytest.mark.parametrize("mutation", TILE_MUTATIONS)
def test_tile_mutated_models_fail(mutation):
    """Each mutation of K2's or B2's model breaks the prefetch order or
    gives other bytes or counts than the twin: K2 on random rows, the
    checked B2 on rows with a length of 200 over a slot of set bits."""
    threads, v, lanes = B2_GEOMETRIES[0]
    source = "pairs" if mutation == "pair-order" else "fused4"
    arrays, max_words, bit_offset = _case("random", threads * v, fused=source == "fused4")
    checks = source == "fused4"
    if checks:
        arrays = [a.copy() for a in arrays]
        arrays[4][1, 5] = 200
        for a in arrays[:4]:
            a[1, 5] = -1
    try:
        got = model_tiles(source, arrays, max_words, bit_offset, threads, v, lanes, checks,
                          mutation=mutation)
    except AssertionError as e:
        assert "prefetch order" in str(e)
        return
    assert not _matches(got, _twin(source, arrays, max_words, bit_offset, checks))


@pytest.mark.parametrize("seed", range(4))
def test_look_back_finds_the_exclusive_prefix(seed):
    """Whatever mix of aggregates and prefixes the predecessors have
    published, the look-back sums to the tile's exclusive prefix, also
    over several windows of lanes."""
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 200, 70).tolist()
    incl = np.cumsum(totals).tolist()
    for t in range(1, 70):
        p_share = rng.random() * 0.3
        status = [("P", incl[j]) if j == 0 or rng.random() < p_share else ("A", totals[j])
                  for j in range(t)]
        assert _look_back(status, t, 4) == incl[t - 1]


def test_backward_read_skips_empty_chunks_and_zero_runs():
    """A word whose leading bits lie three chunks back, behind two empty
    chunks and a zero run, is filled from the codes there."""
    chunk, lanes = 8, 4
    ln = [0] * 40
    c = [0] * 40
    ln[5], c[5] = 3, 0b101  # chunk 0, followed by zeros
    ln[33], c[33] = 4, 0b1111  # chunk 4
    totals = [sum(ln[h * chunk:(h + 1) * chunk]) for h in range(5)]
    assert totals[1:4] == [0, 0, 0]
    start = 38 + 3  # chunk 4's first bit
    back = _back_bits(c, ln, totals, 32, start, max(start & ~31, 38), chunk, lanes)
    assert back == 0b101 << (32 - 9)  # bits 38..40 of word 1
