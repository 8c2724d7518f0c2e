"""JPEG files of natural content, as a camera or an export writes them with
libjpeg's `cjpeg -quality 75 -restart 1`: baseline JFIF, 4:2:0 (h2v2),
the Annex K quantization tables scaled to the configuration's
`jpeg_quality` as libjpeg scales them, the Annex K Huffman tables (no
`-optimize`), and a restart marker after every MCU row.  Made here with
plain numpy and scipy, so that the benchmark needs no JPEG library.

The frames: the repository's three fixture images (600 rows x 400
columns) tiled over the frame, frame i from image i mod 3, shifted down
by a seeded offset and each tile row across by a seeded offset of its
own; then full-range JFIF YCbCr with each 2 x 2 of chroma averaged
(`fixture_tiles.planes_420`), the orthonormal 8 x 8 DCT of each block less
128, quantized.  Every seed tiles whole images over the frame, so every
seed codes about as many bytes.

A batch holds each frame's file in `jpeg` (a row of bytes, `length` of
them used), the byte ranges of its entropy-coded segments (`seg_start`,
`seg_end`: one segment an MCU row, the markers between them), and the
dequantized int16 coefficients it codes (`yc`, `cbc`, `crc`: (frames,
blocks, 64) per component, natural order, as a decoder's entropy stage
hands them over) for the reference; the entry point reads only the bytes.

The stamp moves the entropy-coded segments of three full MCU rows of
every frame round a cycle, in place, with the file's length unchanged:
each segment starts with the DC predictions reset, so the frame decodes
to the same MCU rows in a new order.  The last, partial MCU row never
moves.  A swap of two rows would send every input twice in a cycle of
stamps (the swap of rows a, b is that of b, a); a cycle of three
(r -> r + s -> r + 2 s -> r, mod the full rows R) is a different input
for every (row, shift) pair, when R is prime to 6.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.fft import dctn

from portbench.traffic import fixture_tiles, stamp_rows
from portbench.traffic.jpeg_coeffs import JPEG_CHROMA, JPEG_LUMA

# the natural-order index of each zigzag position
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.3: the DC and AC Huffman tables, luminance then chrominance, as
# (codes of each length 1..16, symbols)
DC_TABLES = (([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
             ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))))
AC_TABLES = (
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex("""
        01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1 08
        23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26 27 28
        29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59
        5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85 86 87 88 89
        8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6
        b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2
        e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9 fa""")),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex("""
        00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42 91
        a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19 1a 26
        27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58
        59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83 84 85 86 87
        88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4
        b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da
        e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9 fa""")),
)
EOB, ZRL = 0x00, 0xF0
BITLEN = np.array([int(v).bit_length() for v in range(4096)])


def _codes(tables) -> tuple[np.ndarray, np.ndarray]:
    """Each table's canonical code and its length, indexed by symbol:
    (tables, 256) arrays."""
    code, length = np.zeros((len(tables), 256), np.int64), np.zeros((len(tables), 256), np.int64)
    for t, (counts, symbols) in enumerate(tables):
        c = k = 0
        for n, count in enumerate(counts, 1):
            for _ in range(count):
                code[t, symbols[k]], length[t, symbols[k]] = c, n
                c, k = c + 1, k + 1
            c <<= 1
    return code, length


DC_CODE, DC_LEN = _codes(DC_TABLES)
AC_CODE, AC_LEN = _codes(AC_TABLES)


def quant_tables(quality: int) -> np.ndarray:
    """(2, 8, 8) luminance and chrominance tables, natural order: Annex
    K's tables scaled as libjpeg's jpeg_quality_scaling and
    jpeg_add_quant_table (force_baseline) scale them."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = np.array([JPEG_LUMA, JPEG_CHROMA])
    return np.clip((base * scale + 50) // 100, 1, 255).reshape(2, 8, 8)


def rgb_frames(rng: np.random.Generator, n: int, height: int, width: int) -> np.ndarray:
    """n (height, width, 3) u8 frames: image i % 3 tiled, shifted down by
    a seeded offset and each tile row across by a seeded offset of its
    own, so that no two MCU rows of a frame hold the same pixels."""
    imgs = fixture_tiles.fixture_images()
    out = np.empty((n, height, width, 3), np.uint8)
    for i in range(n):
        im = imgs[i % len(imgs)]
        ih, iw = im.shape[:2]
        across = np.tile(im, (1, -(-width // iw) + 1, 1))
        dy = int(rng.integers(0, ih))
        rows = [across[:, dx:dx + width] for dx in rng.integers(0, iw, -(-(dy + height) // ih))]
        out[i] = np.concatenate(rows)[dy:dy + height]
    return out


def _mcu_pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _levels(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(rows, cols) u8, whole blocks -> (rows / 8, cols / 8, 64) quantized
    levels, natural order."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = (plane.astype(np.float64) - 128).reshape(bh, 8, bw, 8).swapaxes(1, 2)
    return np.round(dctn(blocks, axes=(-2, -1), norm="ortho") / q).astype(np.int32).reshape(
        bh, bw, 64)


def _extra(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The s extra bits of a value of magnitude category s."""
    return np.where(v < 0, v - 1, v) & ((1 << s) - 1)


def _tokens(levels: np.ndarray, table: np.ndarray, diff: np.ndarray, per_segment: int):
    """The Huffman tokens, (value, bit length) in stream order, of the
    blocks `levels` ((n, 64) zigzag order, `table` 0 luminance or 1
    chrominance, `diff` each DC's difference), a segment every
    `per_segment` blocks ended by 1-bits up to a whole byte.  -> (values,
    lengths, the first token of each segment)."""
    n = len(levels)
    s = BITLEN[np.abs(diff)]
    dc_val = (DC_CODE[table, s] << s) | _extra(diff, s)
    dc_len = DC_LEN[table, s] + s
    b, k = np.nonzero(levels[:, 1:])
    k += 1
    lv = levels[b, k]
    first = np.r_[True, b[1:] != b[:-1]]
    last = np.r_[b[1:] != b[:-1], True]
    run = k - np.where(first, 0, np.r_[0, k[:-1]]) - 1
    zrl, s = run >> 4, BITLEN[np.abs(lv)]
    t = table[b]
    sym = ((run & 15) << 4) | s
    per_nz = zrl + 1  # each nonzero's tokens: its ZRLs, then its own
    ac_tokens = np.bincount(b, weights=per_nz, minlength=n).astype(np.int64)
    eob = np.ones(n, bool)
    eob[b[last]] = k[last] < 63
    seg_end = np.zeros(n, np.int64)
    seg_end[per_segment - 1::per_segment] = 1  # the segment's padding token
    count = 1 + ac_tokens + eob + seg_end
    start = np.cumsum(count) - count
    vals, lens = np.zeros(count.sum(), np.int64), np.zeros(count.sum(), np.int64)
    vals[start], lens[start] = dc_val, dc_len
    before = np.cumsum(per_nz) - per_nz  # tokens of earlier nonzeros, from the first block
    before -= np.repeat(before[first], np.diff(np.r_[np.nonzero(first)[0], len(b)]))
    own = start[b] + 1 + before + zrl
    vals[own] = (AC_CODE[t, sym] << s) | _extra(lv, s)
    lens[own] = AC_LEN[t, sym] + s
    which = np.repeat(np.arange(len(b)), zrl)
    j = np.arange(len(which)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    zpos = own[which] - zrl[which] + j
    vals[zpos], lens[zpos] = AC_CODE[t[which], ZRL], AC_LEN[t[which], ZRL]
    epos = (start + 1 + ac_tokens)[eob]
    vals[epos], lens[epos] = AC_CODE[table[eob], EOB], AC_LEN[table[eob], EOB]
    seg_first = start[::per_segment]
    pad_pos = (start + count - 1)[seg_end == 1]
    pad = -np.add.reduceat(lens, seg_first) % 8
    vals[pad_pos], lens[pad_pos] = (1 << pad) - 1, pad
    return vals, lens, seg_first


def _pack(vals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Tokens of at most 33 bits from any bit offset, summing to whole
    bytes -> the big-endian bytes they spell (each bit is one token's, so
    a byte is the sum of what each token puts in it)."""
    pos = np.cumsum(lens) - lens
    nbytes = int(pos[-1] + lens[-1]) // 8
    window = (vals << (40 - (pos & 7) - lens)).astype(np.uint64)
    out = np.zeros(nbytes + 5)
    for j in range(5):
        out += np.bincount((pos >> 3) + j, weights=((window >> np.uint64(32 - 8 * j))
                                                    & np.uint64(0xFF)).astype(np.float64),
                           minlength=nbytes + 5)
    return out[:nbytes].astype(np.uint8)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def headers(height: int, width: int, q: np.ndarray, mcus_per_restart: int) -> bytes:
    """SOI and every marker segment up to the scan's data: JFIF, DQT, SOF0
    (3 components, Y 2 x 2), DHT (the four Annex K tables), DRI, SOS."""
    dqt = b"".join(bytes([t]) + bytes(q[t].reshape(-1)[ZIGZAG].tolist()) for t in (0, 1))
    dht = b"".join(bytes([cls << 4 | t]) + bytes(counts) + bytes(symbols)
                   for t in (0, 1) for cls, (counts, symbols) in
                   ((0, DC_TABLES[t]), (1, AC_TABLES[t])))
    sof = (bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
           + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    return (b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, sof) + _segment(0xC4, dht)
            + _segment(0xDD, mcus_per_restart.to_bytes(2, "big"))
            + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))


def encode(rgb: np.ndarray, quality: int):
    """One (height, width, 3) u8 frame -> (its JFIF bytes, each MCU row's
    entropy-coded segment as [start, end) byte offsets in them, its
    dequantized int16 coefficients (blocks, 64) per component, natural
    order)."""
    (y,), (cb,), (cr,) = fixture_tiles.planes_420(rgb[None])
    height, width = y.shape
    mr, mc = -(-height // 16), -(-width // 16)
    q = quant_tables(quality)
    yl = _levels(_mcu_pad(y, 16 * mr, 16 * mc), q[0])
    cl = [_levels(_mcu_pad(c, 8 * mr, 8 * mc), q[1]) for c in (cb, cr)]
    # stream order: each MCU's four luminance blocks, then Cb, then Cr
    mcus = np.concatenate([yl.reshape(mr, 2, mc, 2, 64).swapaxes(1, 2).reshape(mr, mc, 4, 64),
                           cl[0][:, :, None], cl[1][:, :, None]], axis=2)
    dc = mcus[..., 0]
    diff = np.concatenate([  # DC predictions restart with every MCU row
        np.diff(dc[:, :, :4].reshape(mr, 4 * mc), axis=1, prepend=0).reshape(mr, mc, 4),
        np.diff(dc[:, :, 4:], axis=1, prepend=0)], axis=2)
    if np.abs(diff).max() >= 2048 or max(-mcus.min(), mcus.max()) >= 1024:
        raise ValueError("levels out of baseline JPEG's range")
    table = np.tile(np.array([0, 0, 0, 0, 1, 1]), mr * mc)
    vals, lens, seg_first = _tokens(mcus.reshape(-1, 64)[:, ZIGZAG], table, diff.reshape(-1),
                                    6 * mc)
    data = _pack(vals, lens)
    starts = (np.cumsum(lens) - lens)[seg_first] >> 3
    ff = np.nonzero(data == 0xFF)[0]
    data = np.insert(data, ff + 1, 0)  # byte stuffing
    starts = starts + np.searchsorted(ff, starts)
    ends = np.r_[starts[1:], len(data)]
    marks = np.ravel([[0xFF, 0xD0 + i % 8] for i in range(mr - 1)]).astype(np.uint8)
    data = np.insert(data, np.repeat(starts[1:], 2), marks)  # RST0..7 between the segments
    head = headers(height, width, q, mc)
    shift = len(head) + 2 * np.arange(mr)
    body = np.concatenate([np.frombuffer(head, np.uint8), data, [0xFF, 0xD9]]).astype(np.uint8)
    ch, cw = -(-height // 2), -(-width // 2)
    cbh, cbw = -(-ch // 8), -(-cw // 8)
    coeffs = [(lv[:bh, :bw] * qt.reshape(64)).astype(np.int16).reshape(-1, 64)
              for lv, bh, bw, qt in ((yl, -(-height // 8), -(-width // 8), q[0]),
                                     (cl[0], cbh, cbw, q[1]), (cl[1], cbh, cbw, q[1]))]
    return body, np.stack([starts + shift, ends + shift], 1), coeffs


def make(config: dict, mix: dict, rng: np.random.Generator) -> dict:
    """One batch of the call's frames as JFIF files, with the segments'
    offsets and the coefficients they code."""
    if config["restart_rows"] != 1 or config["sampling"] != "4:2:0 (h2v2)":
        raise ValueError("the generator writes 4:2:0 files with a restart every MCU row")
    n, h, w = config["frames_per_call"], config["height"], config["width"]
    rgb = rgb_frames(rng, n, h, w)
    # a frame a job: numpy and scipy release the GIL for most of the work
    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as ex:
        files = list(ex.map(lambda f: encode(f, config["jpeg_quality"]), rgb))
    jpeg = np.zeros((n, h * w), np.uint8)  # room for 8 bits a pixel, whatever the seed
    for row, (body, _, _) in zip(jpeg, files):
        row[:len(body)] = body
    return {"jpeg": jpeg, "length": np.array([len(f[0]) for f in files]),
            "seg_start": np.stack([f[1][:, 0] for f in files]),
            "seg_end": np.stack([f[1][:, 1] for f in files]),
            **{k: np.stack([f[2][c] for f in files]) for c, k in enumerate(("yc", "cbc", "crc"))}}


def full_rows(config: dict) -> int:
    """The full MCU rows of a frame: the rows the stamps move."""
    rows = config["height"] // 16
    if np.gcd(rows, 6) != 1:
        raise ValueError(f"{rows} full MCU rows: the stamps' cycles need a count prime to 6")
    return rows


def stamp(config: dict, key: np.ndarray, k: int) -> dict:
    """Per frame a full MCU row r and a step s in 1..R - 1: the cycle
    r -> r + s -> r + 2 s -> r (mod R)."""
    rows = full_rows(config)
    return stamp_rows(key, k, rows, rows - 1)


def cycles(config: dict, stamp: dict) -> list[tuple[int, int, int]]:
    """Each frame's three rows (a, b, c): row a's segment moves to b, b's
    to c and c's to a."""
    rows = full_rows(config)
    return [(r, (r + s) % rows, (r + 2 * s) % rows)
            for r, s in zip(stamp["rows"], stamp["shifts"])]


def apply(batch: dict, config: dict, stamp: dict):
    saved = []
    for f, (a, b, c) in enumerate(cycles(config, stamp)):
        st, en = batch["seg_start"][f], batch["seg_end"][f]
        lo, mid, hi = sorted((a, b, c))
        view = batch["jpeg"][f, st[lo]:en[hi]]
        orig = view.copy()
        src = {b: a, c: b, a: c}  # each position's new segment
        seg = {p: orig[st[src[p]] - st[lo]:en[src[p]] - st[lo]] for p in (lo, mid, hi)}
        view[...] = np.concatenate([seg[lo], orig[en[lo] - st[lo]:st[mid] - st[lo]], seg[mid],
                                    orig[en[mid] - st[lo]:st[hi] - st[lo]], seg[hi]])
        saved.append((view, orig))

    def undo():
        for view, orig in saved:
            view[...] = orig

    return undo
