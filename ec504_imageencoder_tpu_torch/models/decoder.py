"""MPEG-1 intra video elementary stream decoder (verification oracle).

Compliance of the correct-mode encoder is checked with this independent
decoder, which needs no ffmpeg: it parses the ES
bit-by-bit straight from ISO 11172-2 semantics (sequence/GOP/picture/
slice/macroblock/block layers, custom intra matrices, differential DC,
signed AC VLCs, escapes, mismatch control) and reconstructs RGB frames
for PSNR measurement.  It shares only the static code tables with the
encoder — the decode path is written against the spec, not against the
encoder's structure, so it catches asymmetric bugs.

Realizes the reference's latent decode direction (image_processing.c:
438-693, never called there) as a working verifier.

The port's copy of the JAX package's `models/decoder.py`, with the same
names, pixels and errors (tests/test_torch_decoder.py holds it equal).  It
stays host numpy and takes no device, as the reference's does: the
reference's decoder touches no device, its parse is sequential by nature
(each VLC's length decides where the next starts), and a device route
would be a feature the JAX package lacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ec504_imageencoder_tpu_torch.ops.color import upsample_420, ycbcr_to_rgb_f32
from ec504_imageencoder_tpu_torch.ops.dct import dct_matrix_f32
from ec504_imageencoder_tpu_torch.utils import tables


class StreamError(ValueError):
    """Base class for malformed-bitstream errors (subclasses ValueError so
    pre-existing callers catching ValueError keep working)."""


class TruncatedStreamError(StreamError):
    """The stream ended mid-structure (e.g. a cut-off file)."""


class CorruptStreamError(StreamError):
    """The stream is syntactically invalid (bad VLC prefix, bad marker,
    out-of-range coefficient index, headers out of order)."""


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0  # bit position

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise TruncatedStreamError(
                f"stream truncated: need {n} bits at bit {self.pos}, "
                f"stream has {self.nbits}"
            )
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def peek(self, n: int) -> int:
        save = self.pos
        v = self.read(n)
        self.pos = save
        return v

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def at_start_code(self) -> bool:
        self.align()
        return _start_code_follows(self.data, self.pos >> 3)

    def next_start_code(self) -> int | None:
        """Align and scan to the next 00 00 01 xx; returns xx."""
        self.align()
        byte = self.pos >> 3
        while byte + 4 <= len(self.data):
            if self.data[byte : byte + 3] == b"\x00\x00\x01":
                self.pos = (byte + 4) << 3
                return self.data[byte + 3]
            byte += 1
        return None


def _start_code_follows(data: bytes, byte: int) -> bool:
    """True where data[byte:] is zero bytes then 00 00 01: a start code,
    after the zero_byte stuffing that ISO 11172-2's next_start_code()
    allows (the rate control pads pictures so)."""
    if data[byte:byte + 2] != b"\x00\x00":
        return False
    one = data.find(b"\x01", byte + 2)
    return one >= 0 and not data[byte:one].strip(b"\x00")


def _prefix_decoder(pairs):
    """{bitstring: value} -> function(reader) -> value."""
    table = dict(pairs)
    maxlen = max(len(k) for k in table)

    def decode(r: BitReader):
        bits = ""
        for _ in range(maxlen):
            bits += str(r.read(1))
            if bits in table:
                return table[bits]
        raise CorruptStreamError(f"invalid VLC prefix {bits!r} at bit {r.pos}")

    return decode


def _build_decoders():
    dc_luma = _prefix_decoder(
        (format(int(c), f"0{int(l)}b"), s)
        for s, (c, l) in enumerate(zip(tables.DC_SIZE_LUMA_CODE, tables.DC_SIZE_LUMA_LEN))
    )
    dc_chroma = _prefix_decoder(
        (format(int(c), f"0{int(l)}b"), s)
        for s, (c, l) in enumerate(zip(tables.DC_SIZE_CHROMA_CODE, tables.DC_SIZE_CHROMA_LEN))
    )
    ac_entries = {"10": "eob", "000001": "esc", "11": (0, 1)}
    for run in range(32):
        for lvl in range(41):
            ln = int(tables.AC_LEN_CORRECT[run, lvl])
            if ln:
                ac_entries[format(int(tables.AC_CODE_CORRECT[run, lvl]), f"0{ln}b")] = (run, lvl)
    ac = _prefix_decoder(ac_entries.items())
    mba = _prefix_decoder(
        (format(int(c), f"0{int(l)}b"), v)
        for v, (c, l) in enumerate(zip(tables.MB_ADDRESS_CODE, tables.MB_ADDRESS_LEN))
        if l
    )
    return dc_luma, dc_chroma, ac, mba


_DC_LUMA_DEC, _DC_CHROMA_DEC, _AC_DEC, _MBA_DEC = _build_decoders()


@dataclass
class SequenceInfo:
    width: int
    height: int
    aspect: int
    frame_rate_code: int
    intra_matrix: np.ndarray = field(default_factory=lambda: tables.INTRA_Q_MATRIX.copy())


def _read_sequence_header(r: BitReader) -> SequenceInfo:
    w = r.read(12)
    h = r.read(12)
    aspect = r.read(4)
    rate = r.read(4)
    r.read(18)  # bitrate
    if r.read(1) != 1:
        raise CorruptStreamError("sequence header marker bit is zero")
    r.read(10)  # vbv
    r.read(1)   # constrained
    if r.read(1):  # load_intra_quantizer_matrix
        zz = np.array([r.read(8) for _ in range(64)], np.int32)
        m = np.empty(64, np.int32)
        m[tables.ZIGZAG_GATHER] = zz  # undo zigzag transmission order
        intra = m.reshape(8, 8)
    else:
        intra = tables.INTRA_Q_MATRIX.copy()
    if r.read(1):  # load_non_intra
        for _ in range(64):
            r.read(8)
    return SequenceInfo(w, h, aspect, rate, intra)


def _decode_block(r: BitReader, is_luma: bool, dc_pred: int, intra_q: np.ndarray, qscale: int):
    """Returns (reconstructed F (8,8) int32, new dc_pred)."""
    size = (_DC_LUMA_DEC if is_luma else _DC_CHROMA_DEC)(r)
    if size:
        bits = r.read(size)
        diff = bits if bits >= (1 << (size - 1)) else bits - (1 << size) + 1
    else:
        diff = 0
    dc_level = dc_pred + diff
    coeffs = np.zeros(64, np.int32)
    coeffs[0] = dc_level * 8
    idx = 0
    while True:
        sym = _AC_DEC(r)
        if sym == "eob":
            break
        if sym == "esc":
            run = r.read(6)
            b1 = r.read(8)
            if b1 == 0x00:
                level = r.read(8)
            elif b1 == 0x80:
                level = r.read(8) - 256
            else:
                level = b1 - 256 if b1 & 0x80 else b1
        else:
            run, level = sym
            if r.read(1):
                level = -level
        idx += run + 1
        if idx > 63:
            raise CorruptStreamError(f"AC index overflow at bit {r.pos}")
        # ZIGZAG_GATHER[k] = flat block index of scan position k
        zr, zc = divmod(int(tables.ZIGZAG_GATHER[idx]), 8)
        # reconstruction per ISO 11172-2 §2.4.4.2 (intra): truncating
        # division, mismatch control toward zero, clamp
        f = 2 * level * qscale * int(intra_q[zr, zc])
        f = (abs(f) // 16) * (1 if f >= 0 else -1)
        if f > 0 and f % 2 == 0:
            f -= 1
        elif f < 0 and (-f) % 2 == 0:
            f += 1
        f = max(-2048, min(2047, f))
        coeffs[zr * 8 + zc] = f
    return coeffs.reshape(8, 8), dc_level


_DCT_M = dct_matrix_f32().astype(np.float64)


def _idct(f: np.ndarray) -> np.ndarray:
    pix = _DCT_M.T @ f.astype(np.float64) @ _DCT_M
    return np.clip(np.round(pix), 0, 255).astype(np.uint8)


def decode_es(data: bytes, color_range: str = "studio") -> list[np.ndarray]:
    """Decode an all-intra MPEG-1 video ES into RGB frames.

    color_range must match the encoder's ("studio" is both defaults —
    MPEG-1 streams carry no range signaling, like any standard decoder
    we assume limited range unless told otherwise)."""
    r = BitReader(data)
    frames: list[np.ndarray] = []
    seq: SequenceInfo | None = None
    cur = None  # (y, cb, cr) planes for the current picture

    def flush():
        nonlocal cur
        if cur is not None:
            y, cb, cr = cur
            rgb = ycbcr_to_rgb_f32(
                y, upsample_420(cb), upsample_420(cr), color_range=color_range
            )
            frames.append(rgb[: seq.height, : seq.width])
            cur = None

    while True:
        code = r.next_start_code()
        if code is None:
            flush()
            break
        if code == 0xB3:
            seq = _read_sequence_header(r)
        elif code == 0xB8:
            r.read(32)  # timecode etc.
        elif code == 0x00:
            if seq is None:
                raise CorruptStreamError(
                    "picture header before any sequence header"
                )
            flush()
            r.read(10)  # temporal ref
            ptype = r.read(3)
            if ptype != 1:
                raise CorruptStreamError(
                    f"only I pictures supported, got picture type {ptype}"
                )
            r.read(16)  # vbv_delay
            mbw = (seq.width + 15) // 16
            mbh = (seq.height + 15) // 16
            cur = (
                np.zeros((mbh * 16, mbw * 16), np.uint8),
                np.zeros((mbh * 8, mbw * 8), np.uint8),
                np.zeros((mbh * 8, mbw * 8), np.uint8),
            )
        elif code == 0xB7:
            flush()
            break
        elif 0x01 <= code <= 0xAF:
            if cur is None:
                raise CorruptStreamError(
                    "slice start code before any picture header"
                )
            row = code - 1
            if row >= (seq.height + 15) // 16:
                raise CorruptStreamError(
                    f"slice vertical position {row + 1} beyond the "
                    f"{seq.height}-px-high picture"
                )
            qscale = r.read(5)
            while r.read(1):
                r.read(8)  # extra slice info
            mbw = (seq.width + 15) // 16
            y, cb, cr = cur
            dc_y = dc_cb = dc_cr = 128
            mb_addr = -1
            while True:
                inc = _MBA_DEC(r)
                while inc == tables.MB_ESCAPE:
                    mb_addr += 33
                    inc = _MBA_DEC(r)
                if inc == tables.MB_STUFFING:
                    continue
                mb_addr += inc
                col = mb_addr % mbw
                # macroblock_type for I: '1' = intra, '01' = intra+quant
                if not r.read(1):
                    if r.read(1) != 1:
                        raise CorruptStreamError(
                            f"bad I-picture macroblock type at bit {r.pos}"
                        )
                    qscale = r.read(5)
                for b in range(4):
                    f, dc_y = _decode_block(r, True, dc_y, seq.intra_matrix, qscale)
                    br, bc = row * 16 + (b // 2) * 8, col * 16 + (b % 2) * 8
                    y[br : br + 8, bc : bc + 8] = _idct(f)
                f, dc_cb = _decode_block(r, False, dc_cb, seq.intra_matrix, qscale)
                cb[row * 8 : row * 8 + 8, col * 8 : col * 8 + 8] = _idct(f)
                f, dc_cr = _decode_block(r, False, dc_cr, seq.intra_matrix, qscale)
                cr[row * 8 : row * 8 + 8, col * 8 : col * 8 + 8] = _idct(f)
                # byte-aligned zero padding before the next start code ends
                # the slice; detect: all remaining bits to alignment zero
                # and the following bytes are 00 00 01
                save = r.pos
                if r.at_start_code():
                    break
                r.pos = save
    return frames


# ---------------------------------------------------------------------------
# Fast verification decoder
#
# The scalar decode_es above is the readable spec oracle, but its per-bit
# Python reads make 1080p streams impractical (r4 VERDICT item 6).  This
# path keeps the parse scalar (VLC decode is inherently sequential) but
# makes each symbol O(1): a numpy-windowed bit reader + flat lookup
# tables, with ALL numeric reconstruction (dequant, mismatch control,
# IDCT, plane assembly, upsample, color) batched over numpy per picture.
# Cross-validated bit-for-bit against decode_es (tests/test_decoder_fast).

class _FastReader:
    """Bit reader with O(1) reads via precomputed 64-bit byte windows.

    Memory: the window table is 8 bytes per stream byte — fine for
    verification streams (tens of MB); for multi-GB inputs decode
    GOP-sized chunks instead."""

    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0
        pad = np.frombuffer(data + b"\x00" * 8, np.uint8)
        # w64[i] = 8 bytes starting at byte i, big-endian
        w = pad.astype(np.uint64)
        acc = np.zeros(len(data) + 1, np.uint64)
        for k in range(8):
            acc |= w[k : len(data) + 1 + k] << np.uint64(8 * (7 - k))
        self._w64 = acc

    def read(self, n: int) -> int:
        p = self.pos
        if p + n > self.nbits:
            raise TruncatedStreamError(
                f"stream truncated: need {n} bits at bit {p}"
            )
        self.pos = p + n
        return (int(self._w64[p >> 3]) >> (64 - n - (p & 7))) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        # reads past the end return zero bits (callers check lengths)
        p = self.pos
        if (p >> 3) >= len(self._w64):
            return 0
        return (int(self._w64[p >> 3]) >> (64 - n - (p & 7))) & ((1 << n) - 1)

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def at_start_code(self) -> bool:
        self.align()
        return _start_code_follows(self.data, self.pos >> 3)

    def next_start_code(self) -> int | None:
        self.align()
        byte = self.pos >> 3
        idx = self.data.find(b"\x00\x00\x01", byte)
        if idx < 0 or idx + 4 > len(self.data):
            return None
        self.pos = (idx + 4) << 3
        return self.data[idx + 3]


def _flat_lut(pairs, maxlen):
    """[(code_str_len... as (code,len,value))] -> (val, len) arrays of
    size 2**maxlen indexed by the next maxlen bits."""
    val = np.zeros(1 << maxlen, np.int32)
    ln = np.zeros(1 << maxlen, np.int8)
    for code, length, value in pairs:
        lo = code << (maxlen - length)
        hi = lo + (1 << (maxlen - length))
        val[lo:hi] = value
        ln[lo:hi] = length
    return val, ln


def _build_fast_luts():
    dc_l = _flat_lut(
        [(int(c), int(l), s) for s, (c, l) in enumerate(
            zip(tables.DC_SIZE_LUMA_CODE, tables.DC_SIZE_LUMA_LEN))], 7)
    dc_c = _flat_lut(
        [(int(c), int(l), s) for s, (c, l) in enumerate(
            zip(tables.DC_SIZE_CHROMA_CODE, tables.DC_SIZE_CHROMA_LEN))], 8)
    # AC: value = run * 64 + |level|; specials: EOB = -1, escape = -2,
    # first '11' handled by callers via the (0,1) row it already maps to
    ac_pairs = [(0b10, 2, -1), (0b000001, 6, -2), (0b11, 2, 0 * 64 + 1)]
    for run in range(32):
        for lvl in range(41):
            L = int(tables.AC_LEN_CORRECT[run, lvl])
            if L:
                ac_pairs.append(
                    (int(tables.AC_CODE_CORRECT[run, lvl]), L, run * 64 + lvl))
    ac = _flat_lut(ac_pairs, 16)
    mba = _flat_lut(
        [(int(c), int(l), v) for v, (c, l) in enumerate(
            zip(tables.MB_ADDRESS_CODE, tables.MB_ADDRESS_LEN)) if l], 11)
    return dc_l, dc_c, ac, mba


_FAST_LUTS = _build_fast_luts()


def _reconstruct_picture(seq, qscales, dcs, pairs, nblk):
    """Vectorized per-picture reconstruction.

    qscales: (nblk,) int32 quantizer per block; dcs: (nblk,) DC levels;
    pairs: (n_coef, 3) int32 rows (block_id, scan_idx, level)."""
    intra_flat = seq.intra_matrix.reshape(64).astype(np.int64)
    coeffs = np.zeros((nblk, 64), np.int64)
    coeffs[:, 0] = dcs.astype(np.int64) * 8
    if len(pairs):
        bid, scan, lvl = pairs[:, 0], pairs[:, 1], pairs[:, 2].astype(np.int64)
        flat = tables.ZIGZAG_GATHER[scan]  # natural flat index
        f = 2 * lvl * qscales[bid].astype(np.int64) * intra_flat[flat]
        f = np.abs(f) // 16 * np.sign(f)
        even = (f % 2 == 0)
        f = np.where((f > 0) & even, f - 1, f)
        f = np.where((f < 0) & even, f + 1, f)
        np.clip(f, -2048, 2047, out=f)
        coeffs[bid, flat] = f
    # batched orthonormal IDCT
    fm = coeffs.reshape(nblk, 8, 8).astype(np.float64)
    pix = np.einsum("yv,nvu,ux->nyx", _DCT_M.T, fm, _DCT_M)
    return np.clip(np.round(pix), 0, 255).astype(np.uint8)


def decode_es_fast(data: bytes, color_range: str = "studio") -> list[np.ndarray]:
    """Fast decode_es: same streams, same pixels, ~2 orders of magnitude
    faster — practical for 1080p RD curves."""
    (dclv, dcll), (dccv, dccl), (acv, acl), (mbav, mbal) = _FAST_LUTS
    r = _FastReader(data)
    frames: list[np.ndarray] = []
    seq = None
    pic = None  # per-picture accumulators

    def flush():
        nonlocal pic
        if pic is None:
            return
        qs, dcs, pairs, meta = pic
        nblk = len(dcs)
        blocks = _reconstruct_picture(
            seq,
            np.asarray(qs, np.int32),
            np.asarray(dcs, np.int32),
            np.asarray(pairs, np.int64).reshape(-1, 3),
            nblk,
        )
        mbw = (seq.width + 15) // 16
        mbh = (seq.height + 15) // 16
        y = np.zeros((mbh * 16, mbw * 16), np.uint8)
        cb = np.zeros((mbh * 8, mbw * 8), np.uint8)
        cr = np.zeros((mbh * 8, mbw * 8), np.uint8)
        m = np.asarray(meta, np.int32).reshape(-1, 3)  # (row, col, bidx)
        for comp, plane in ((4, cb), (5, cr)):
            sel = m[:, 2] == comp
            rows, cols = m[sel, 0], m[sel, 1]
            bl = blocks[sel]
            for k in range(len(rows)):
                plane[rows[k] * 8 : rows[k] * 8 + 8,
                      cols[k] * 8 : cols[k] * 8 + 8] = bl[k]
        sel = m[:, 2] < 4
        rows, cols, b = m[sel, 0], m[sel, 1], m[sel, 2]
        bl = blocks[sel]
        br = rows * 16 + (b // 2) * 8
        bc = cols * 16 + (b % 2) * 8
        for k in range(len(br)):
            y[br[k] : br[k] + 8, bc[k] : bc[k] + 8] = bl[k]
        rgb = ycbcr_to_rgb_f32(
            y, upsample_420(cb), upsample_420(cr), color_range=color_range
        )
        frames.append(rgb[: seq.height, : seq.width])
        pic = None

    while True:
        code = r.next_start_code()
        if code is None:
            flush()
            break
        if code == 0xB3:
            seq = _read_sequence_header(r)
        elif code == 0xB8:
            r.read(32)
        elif code == 0x00:
            if seq is None:
                raise CorruptStreamError(
                    "picture header before any sequence header"
                )
            flush()
            r.read(10)
            ptype = r.read(3)
            if ptype != 1:
                raise CorruptStreamError(
                    f"only I pictures supported, got picture type {ptype}"
                )
            r.read(16)
            pic = ([], [], [], [])
        elif code == 0xB7:
            flush()
            break
        elif 0x01 <= code <= 0xAF:
            if pic is None:
                raise CorruptStreamError(
                    "slice start code before any picture header"
                )
            row = code - 1
            if row >= (seq.height + 15) // 16:
                raise CorruptStreamError(
                    f"slice vertical position {row + 1} beyond the "
                    f"{seq.height}-px-high picture"
                )
            qscale = r.read(5)
            while r.read(1):
                r.read(8)
            mbw = (seq.width + 15) // 16
            qs, dcs, pairs, meta = pic
            dc_y = dc_cb = dc_cr = 128
            mb_addr = -1
            while True:
                v = r.peek(11)
                inc, L = int(mbav[v]), int(mbal[v])
                if L == 0:
                    raise CorruptStreamError(
                        f"invalid MBA prefix at bit {r.pos}")
                r.pos += L
                while inc == tables.MB_ESCAPE:
                    mb_addr += 33
                    v = r.peek(11)
                    inc, L = int(mbav[v]), int(mbal[v])
                    if L == 0:
                        raise CorruptStreamError(
                            f"invalid MBA prefix at bit {r.pos}")
                    r.pos += L
                if inc == tables.MB_STUFFING:
                    continue
                mb_addr += inc
                col = mb_addr % mbw
                if not r.read(1):
                    if r.read(1) != 1:
                        raise CorruptStreamError(
                            f"bad I-picture macroblock type at bit {r.pos}"
                        )
                    qscale = r.read(5)
                for b in range(6):
                    is_luma = b < 4
                    if is_luma:
                        v = r.peek(7)
                        size, L = int(dclv[v]), int(dcll[v])
                    else:
                        v = r.peek(8)
                        size, L = int(dccv[v]), int(dccl[v])
                    if L == 0:
                        raise CorruptStreamError(
                            f"invalid DC size prefix at bit {r.pos}")
                    r.pos += L
                    if size:
                        bits = r.read(size)
                        diff = (bits if bits >= (1 << (size - 1))
                                else bits - (1 << size) + 1)
                    else:
                        diff = 0
                    if b < 4:
                        dc_y += diff
                        dc = dc_y
                    elif b == 4:
                        dc_cb += diff
                        dc = dc_cb
                    else:
                        dc_cr += diff
                        dc = dc_cr
                    bid = len(dcs)
                    dcs.append(dc)
                    qs.append(qscale)
                    meta.append((row, col, b))
                    idx = 0
                    while True:
                        v = r.peek(16)
                        sym, L = int(acv[v]), int(acl[v])
                        if L == 0:
                            raise CorruptStreamError(
                                f"invalid AC prefix at bit {r.pos}")
                        r.pos += L
                        if sym == -1:  # EOB
                            break
                        if sym == -2:  # escape
                            run = r.read(6)
                            b1 = r.read(8)
                            if b1 == 0x00:
                                level = r.read(8)
                            elif b1 == 0x80:
                                level = r.read(8) - 256
                            else:
                                level = b1 - 256 if b1 & 0x80 else b1
                        else:
                            run, level = sym >> 6, sym & 63
                            if r.read(1):
                                level = -level
                        idx += run + 1
                        if idx > 63:
                            raise CorruptStreamError(
                                f"AC index overflow at bit {r.pos}")
                        pairs.append((bid, idx, level))
                    if r.pos > r.nbits:
                        raise TruncatedStreamError(
                            f"stream truncated at bit {r.pos}")
                save = r.pos
                if r.at_start_code():
                    break
                r.pos = save
    return frames


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def decode_stream(data: bytes, color_range: str = "studio",
                  fast: bool = True) -> list[np.ndarray]:
    """Decode either container: auto-demux a program stream (pack start
    code 0x000001BA first) or decode a raw video ES.  fast=True uses the
    LUT/batched path (bit-identical to the scalar oracle, locked by
    tests/test_decoder_fast.py); fast=False runs the readable spec
    oracle."""
    if data[:4] == b"\x00\x00\x01\xba":
        from ec504_imageencoder_tpu_torch.syntax.mux import demux_program_stream

        data = demux_program_stream(data)
    dec = decode_es_fast if fast else decode_es
    return dec(data, color_range=color_range)
