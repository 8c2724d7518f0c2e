"""A plain model of how K1 (`pack_raw`), K3 (`pack_windows`) and K4
(`pack_split`) cut a row of raw codes, held against the twin
`cuda_pack.pack_raw_plain`.

The CUDA kernels (`csrc/pack_fused4.cu`, `csrc/pack_split.cu`) cannot run
on the CPU, so this file rehearses their decomposition with small tiles
(8 to 64 codes, and a "warp" of 2 to 8 lanes) so that tile boundaries come
often:

* K1: one block per row; a tile is `threads` x V codes, thread tid holding
  the V consecutive codes tid V .. tid V + V - 1 of it, loaded together
  (whole groups of 4 with 16-byte loads when K % 4 == 0, else one by one;
  codes past the row read as length 0); the loads of tile t + 1 go out before
  tile t's barrier; per tile a "warp" scan of the thread sums, the
  warp totals in one half of a double buffer, each thread's offset from
  its warp's prefix and the running carry, which every thread keeps; its
  codes placed one after another from there; nbits is the final carry.
  Mutations (no carry, an inclusive offset, the next tile loaded after
  the barrier) each fail.

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
342,528 B buffer that K1 keeps in global memory.
Tolerance: exact (0).  Nothing in the port imports this model.
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


def model_raw(codes, lens, max_words: int, bit_offset: int, threads: int, v: int, lanes: int,
              mutation=None):
    """K1, the order of its steps kept per tile: -> (words, nbits)."""
    n, k = lens.shape
    warps, tile = threads // lanes, threads * v
    vec = k % 4 == 0
    ntiles = -(-k // tile)
    tid = np.arange(threads)
    out = np.zeros((n, max_words), np.int64)
    nbits = np.zeros(n, np.int64)
    for r in range(n):
        c = codes[r].astype(np.int64) & M32
        ln = lens[r].astype(np.int64)
        events = []

        def load(t):
            i = t * tile + v * tid[:, None] + np.arange(v)  # (threads, v)
            inside = i < k
            if vec:  # 16-byte loads: a group of 4 is read whole or not at all
                group = i - np.arange(v) % 4
                assert np.array_equal(group < k, inside)
            events.append(("load", t))
            j = np.minimum(i, max(k - 1, 0))
            return np.where(inside, ln[j] if k else 0, 0), np.where(inside, c[j] if k else 0, 0)

        cur = load(0)
        carry = bit_offset
        s_warp = np.zeros((2, warps), np.int64)
        for t in range(ntiles):
            if mutation != "load-after-barrier":
                nxt = load(t + 1)
            tl, tc = cur
            sums = tl.sum(axis=1)
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
                for e in range(v):
                    length = int(tl[th, e])
                    if length > 0:
                        w0, w1 = _place(int(tc[th, e]), length, o)
                        for w, val in ((o >> 5, w0), ((o >> 5) + 1, w1)):
                            if val and 0 <= w < max_words:
                                out[r, w] |= val
                    o += length
            cur = nxt
        nbits[r] = carry
        for t in range(ntiles):  # tile t + 1 in flight across tile t's barrier
            assert events.index(("load", t + 1)) < events.index(("barrier", t)), "prefetch order"
    return out, nbits


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
# K1: (threads, consecutive codes per thread, lanes of a "warp")
K1_GEOMETRIES = [(8, 4, 4), (4, 8, 2), (16, 4, 8)]
K1_MUTATIONS = ("no-carry", "inclusive-offset", "load-after-barrier")


def _case(case: str, tile: int):
    """-> (codes, lens, max_words, bit_offset) of a case at this tile size."""
    content, n, k, max_words, bit_offset = CASES[case]
    if isinstance(k, str):
        k = tile + {"tile-1": -1, "tile": 0, "tile+1": 1}[k]
    codes, lens = _raw(len(case) + 7 * tile, n, k, content, tile)
    if max_words == "used":
        max_words = max(_used_words(lens, bit_offset), 1)
    elif max_words == "tile2":
        max_words = (bit_offset + int(lens[0, :2 * tile].sum())) >> 5
    return codes, lens, max_words, bit_offset


def _twin(codes, lens, max_words: int, bit_offset: int):
    return cuda_pack.pack_raw_plain(torch.from_numpy(codes), torch.from_numpy(lens), max_words,
                                    bit_offset)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["tile8", "tile32"])
@pytest.mark.parametrize("kernel", list(MODELS))
def test_decomposition_matches_the_twin(kernel, geometry, case):
    tile, lanes = geometry
    codes, lens, max_words, bit_offset = _case(case, tile)
    seg, nbits = _twin(codes, lens, max_words, bit_offset)
    words, got_bits = MODELS[kernel](codes, lens, max_words, bit_offset, tile, lanes,
                                     np.random.default_rng(lens.shape[1]))
    assert np.array_equal(got_bits, nbits.numpy())
    assert torch.equal(bitpack.words_to_bytes(torch.from_numpy(words)), seg)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", K1_GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_k1_tiles_match_the_twin(geometry, case):
    threads, v, lanes = geometry
    codes, lens, max_words, bit_offset = _case(case, threads * v)
    seg, nbits = _twin(codes, lens, max_words, bit_offset)
    words, got_bits = model_raw(codes, lens, max_words, bit_offset, threads, v, lanes)
    assert np.array_equal(got_bits, nbits.numpy())
    assert torch.equal(bitpack.words_to_bytes(torch.from_numpy(words)), seg)


@pytest.mark.parametrize("mutation", K1_MUTATIONS)
def test_k1_mutated_models_fail(mutation):
    """Each mutation of K1's model either breaks the prefetch order or
    gives other bytes than the twin on rows of several tiles."""
    threads, v, lanes = K1_GEOMETRIES[0]
    codes, lens, max_words, bit_offset = _case("random", threads * v)
    seg, nbits = _twin(codes, lens, max_words, bit_offset)
    try:
        words, got_bits = model_raw(codes, lens, max_words, bit_offset, threads, v, lanes,
                                    mutation)
    except AssertionError as e:
        assert "prefetch order" in str(e)
        return
    assert not (np.array_equal(got_bits, nbits.numpy())
                and torch.equal(bitpack.words_to_bytes(torch.from_numpy(words)), seg))


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
