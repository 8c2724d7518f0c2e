"""Vectorised intra VLC emission: zigzag levels -> (code, len) slots.

Port of `ec504_imageencoder_tpu.ops.vlc_device`:

* `block_streams_correct64` (ISO correct mode, 64 slots with the MB
  header and EOB folded in) and `models/mpeg1._dc_predictors`;
  `emit_correct64` is the same with the table lookups passed in (the
  lookup kernel B5 serves them in `ops/cuda_lut.py`);
* `block_streams_correct`, the same emission in the reference's 65-slot
  layout (DC, 63 AC, EOB; no macroblock header);
* `block_streams_compat` and `ac_codes_compat` (the reference C
  encoder's bug-for-bug compat emission, 65 slots).

Codes are carried as int64: torch on the CPU cannot shift or compare
uint32, and every code here is at most 30 bits.
"""

from __future__ import annotations

import torch

from ec504_imageencoder_tpu_torch.utils import tables

_I64 = torch.int64


def _shl(x, k):
    return torch.bitwise_left_shift(x, k)


def _bitlength8(v):
    """bit_length(v) for v in [0, 255]; 0 -> 0."""
    sz = torch.zeros_like(v)
    for k in range(8):
        sz = sz + (v >= (1 << k)).to(v.dtype)
    return sz


def zero_runs(zz, force_slot0: bool):
    """Zeros before each slot since the previous nonzero one.  With
    force_slot0 slot 0 counts as nonzero (correct mode: AC runs never
    reach into the DC); compat mode lets a zero DC count as a zero."""
    idx = torch.arange(64, dtype=_I64, device=zz.device)
    nz = (zz != 0) | (idx == 0) if force_slot0 else zz != 0
    marked = torch.where(nz, idx, torch.full_like(idx, -1))
    prev_incl = torch.cummax(marked, dim=-1).values
    prev = torch.cat([torch.full_like(prev_incl[..., :1], -1), prev_incl[..., :-1]], dim=-1)
    return idx - prev - 1


def _escape_codes(run, al, sign):
    """6-bit escape, 6-bit run, then an 8-bit level (20 bits) or, for
    |level| >= 128, a 16-bit one (28 bits); the same in both modes."""
    lo = torch.where(sign, (256 - al) & 0xFF, al & 0xFF)
    hi = torch.where(sign, 0x80, 0)
    base = 64 | run
    is_long = al >= 128
    e_code = torch.where(is_long, _shl(base, 16) | _shl(hi, 8) | lo, _shl(base, 8) | lo)
    return e_code, torch.where(is_long, 28, 20)


def _table(run, al, ac_code, ac_len):
    """(code, len) of the dense [run, |level|] LUT; len 0 off the table."""
    in_range = (run <= tables.MAX_RUN) & (al <= tables.MAX_AC_LEVEL)
    li = run.clamp(0, tables.MAX_RUN) * (tables.MAX_AC_LEVEL + 1) + al.clamp(
        0, tables.MAX_AC_LEVEL
    )
    t_code = ac_code.reshape(-1).to(_I64)[li]
    return t_code, torch.where(in_range, ac_len.reshape(-1).to(_I64)[li], 0)


def ac_codes_correct(lvl, run, ac_table):
    """Per-slot ISO AC (code, len): table B.5c/d code + sign bit, the
    '11s' special case, or a 20/28-bit escape carrying the TRUE run.
    ac_table(run, |level|) -> (code without sign bit, len), len 0 where
    the table has no row."""
    sign = lvl < 0
    sbit = sign.to(_I64)
    al = lvl.abs()
    t_code, t_len = ac_table(run, al)
    special = (run == 0) & (al == 1)
    in_table = ~special & (t_len > 0)

    e_code, e_len = _escape_codes(run, al, sign)

    code = torch.where(special, 0b110 | sbit,
                       torch.where(in_table, _shl(t_code, 1) | sbit, e_code))
    length = torch.where(special, 3, torch.where(in_table, t_len + 1, e_len))
    return code, length


def block_streams_correct64(zz, dc_pred, is_luma, mb_first, dc_code, dc_len,
                            ac_code, ac_len):
    """ISO intra block emission in the 64-slot layout.

    zz: (..., 64) zigzag levels with slot 0 the absolute DC; dc_pred,
    is_luma, mb_first: (...,).  The 2-bit macroblock header '11' folds
    into the DC slot where mb_first is set, the EOB '10' into slot 63.
    Returns int64 (codes, lens) of shape (..., 64)."""

    def dc_table(luma, sz):
        ti = luma * dc_code.shape[-1] + sz
        return dc_code.reshape(-1).to(_I64)[ti], dc_len.reshape(-1).to(_I64)[ti]

    return emit_correct64(zz, dc_pred, is_luma, mb_first, dc_table,
                          lambda run, al: _table(run, al, ac_code, ac_len))


def emit_correct64(zz, dc_pred, is_luma, mb_first, dc_table, ac_table):
    """`block_streams_correct64` with its two table lookups passed in:
    dc_table(is_luma, size) -> dct_dc_size (code, len); ac_table as for
    `ac_codes_correct`.  Both take and give int64 tensors."""
    zz = zz.to(_I64)
    nz = zz != 0
    dc = zz[..., 0]
    diff = dc - dc_pred.to(_I64)
    sz = _bitlength8(diff.abs().clamp(0, 255))
    one = torch.ones_like(sz)
    v = torch.where(diff >= 0, diff, diff + _shl(one, sz) - 1)
    dc_bits = v & (_shl(one, sz) - 1)
    size_code, size_len = dc_table(is_luma.to(_I64), sz)
    code0 = torch.where(sz > 0, _shl(size_code, sz) | dc_bits, size_code)
    len0 = size_len + sz
    first = mb_first.to(torch.bool)
    code0 = torch.where(first, _shl(torch.full_like(len0, 0b11), len0) | code0, code0)
    len0 = len0 + 2 * first.to(_I64)

    ac, ac_l = ac_codes_correct(zz, zero_runs(zz, force_slot0=True), ac_table)
    ac = torch.where(nz, ac, 0)
    ac_l = torch.where(nz, ac_l, 0)
    lane = torch.arange(64, device=zz.device)
    ac = torch.where(lane == 63, _shl(ac, 2) | 0b10, ac)
    ac_l = torch.where(lane == 63, ac_l + 2, ac_l)
    codes = torch.where(lane == 0, code0[..., None], ac)
    lens = torch.where(lane == 0, len0[..., None], ac_l)
    return codes, lens


def block_streams_correct(zz, dc_pred, is_luma, dc_code, dc_len, ac_code, ac_len):
    """ISO intra block emission in the 65-slot layout: (..., 64) zigzag
    levels with slot 0 the absolute DC, (...,) dc_pred and is_luma ->
    int64 (codes, lens) of shape (..., 65): slot 0 the differential DC,
    slots 1..63 the AC per zigzag position (length 0 where nothing is
    emitted), slot 64 the EOB '10'.  The tables as for
    `block_streams_correct64`."""
    no_header = torch.zeros_like(dc_pred, dtype=torch.bool)
    codes, lens = block_streams_correct64(zz, dc_pred, is_luma, no_header, dc_code, dc_len,
                                          ac_code, ac_len)
    # slot 63 carries the EOB folded in: split it back out
    eob = torch.full_like(codes[..., :1], 0b10)
    return (torch.cat([codes[..., :63], codes[..., 63:] >> 2, eob], dim=-1),
            torch.cat([lens[..., :63], lens[..., 63:] - 2, torch.full_like(eob, 2)], dim=-1))


def ac_codes_compat(lvl, zeros_before, ac_code, ac_len):
    """Per-slot compat AC (code, len): no sign bit, run index
    max(zeros_before - 1, 0), '11' for (run 0, |level| 1), else the
    compat table (`tables.AC_CODE_COMPAT`: its run-0 row for |level| L
    holds the level-(L+1) code, and L = 40 escapes) or an escape.  The
    caller applies the truncation mask."""
    lvl = lvl.to(_I64)
    sign = lvl < 0
    al = lvl.abs()
    ri = (zeros_before.to(_I64) - 1).clamp(min=0)
    special = (ri == 0) & (al == 1)
    t_code, t_len = _table(ri, al, ac_code, ac_len)
    in_table = ~special & (t_len > 0)
    e_code, e_len = _escape_codes(ri, al, sign)
    code = torch.where(special, 0b11, torch.where(in_table, t_code, e_code))
    length = torch.where(special, 2, torch.where(in_table, t_len, e_len))
    return code, length


def block_streams_compat(zz, is_luma, dc_code, dc_len, ac_code, ac_len):
    """Compat block emission, the reference C encoder's bitstream bug for
    bug (mpeg1_blk.c:67-113): (..., 64) quantized zigzag + (...,) luma
    flags -> int64 (codes, lens) of shape (..., 65).

    Slot 0: the ABSOLUTE DC, size max(bit_length(|dc| & 0xFF), 1), no
    prediction; slots 1..63: AC with the Q5 truncation (nothing from the
    first nonzero AC with no zero before it on, the DC counting as a
    position); slot 64: EOB."""
    zz = zz.to(_I64)
    zeros_before = zero_runs(zz, force_slot0=False)
    nz = zz != 0
    one = torch.ones_like(zz[..., 0])

    dc = zz[..., 0]
    dc_nz = dc != 0
    adc = dc.abs()
    sz = _bitlength8(adc & 0xFF).clamp(min=1)
    coe = torch.where(dc < 0, adc ^ _shl(one, sz - 1), adc)
    dc_bits = coe & (_shl(one, sz) - 1)
    ti = is_luma.to(_I64) * dc_code.shape[-1] + torch.where(dc_nz, sz, 0)
    size_code = dc_code.reshape(-1).to(_I64)[ti]
    size_len = dc_len.reshape(-1).to(_I64)[ti]
    code0 = torch.where(dc_nz, _shl(size_code, sz) | dc_bits, size_code)
    len0 = torch.where(dc_nz, size_len + sz, size_len)

    nz_ac = nz[..., 1:]
    bad = nz_ac & (zeros_before[..., 1:] == 0)
    dropped = torch.cummax(bad.to(_I64), dim=-1).values > 0  # inclusive cum-or
    emit = nz_ac & ~dropped
    ac, ac_l = ac_codes_compat(zz[..., 1:], zeros_before[..., 1:], ac_code, ac_len)
    ac = torch.where(emit, ac, 0)
    ac_l = torch.where(emit, ac_l, 0)

    codes = torch.cat([code0[..., None], ac, torch.full_like(code0, 0b10)[..., None]], dim=-1)
    lens = torch.cat([len0[..., None], ac_l, torch.full_like(len0, 2)[..., None]], dim=-1)
    return codes, lens


def dc_predictors(dc: torch.Tensor) -> torch.Tensor:
    """(B, mbh, mbw, 6) DC values -> previous same-component DC in stream
    order, 128 at the start of each slice (macroblock row)."""
    bsz, mbh, mbw, _ = dc.shape
    p128 = torch.full((bsz, mbh, 1), 128, dtype=dc.dtype, device=dc.device)
    luma = dc[..., :4].reshape(bsz, mbh, mbw * 4)
    luma_pred = torch.cat([p128, luma[..., :-1]], dim=-1).reshape(bsz, mbh, mbw, 4)
    cb_pred = torch.cat([p128, dc[..., :-1, 4]], dim=-1)[..., None]
    cr_pred = torch.cat([p128, dc[..., :-1, 5]], dim=-1)[..., None]
    return torch.cat([luma_pred, cb_pred, cr_pred], dim=-1)


def slot_violations(codes, lens):
    """Per-row count of slots that break the invariants the pack relies on
    (the reference's `ops/pallas_vlc.py::slot_violations`): a length
    outside [0, 30], or code bits above the length.  codes/lens: (R, ...)
    integer tensors holding u32 codes -> (R,) int32."""
    c = codes.to(_I64) & 0xFFFFFFFF
    ln = lens.to(_I64)
    mask = _shl(torch.ones_like(ln), ln.clamp(0, 31)) - 1
    bad = (ln < 0) | (ln > 30) | ((c & ~mask) != 0)
    return bad.reshape(bad.shape[0], -1).sum(dim=1).to(torch.int32)
