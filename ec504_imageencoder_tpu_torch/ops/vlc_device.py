"""Vectorised ISO intra VLC emission: zigzag levels -> 64 (code, len) slots.

Port of `ec504_imageencoder_tpu.ops.vlc_device.block_streams_correct64`
and `models/mpeg1._dc_predictors`.  Codes are carried as int64: torch on
the CPU cannot shift or compare uint32, and every code here is at most
30 bits.
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


def _runs_forced(zz):
    """Zeros before each slot since the previous nonzero one, with slot 0
    treated as nonzero (AC runs never reach into the DC)."""
    idx = torch.arange(64, dtype=_I64, device=zz.device)
    marked = torch.where((zz != 0) | (idx == 0), idx, torch.full_like(idx, -1))
    prev_incl = torch.cummax(marked, dim=-1).values
    prev = torch.cat([torch.full_like(prev_incl[..., :1], -1), prev_incl[..., :-1]], dim=-1)
    return idx - prev - 1


def ac_codes_correct(lvl, run, ac_code, ac_len):
    """Per-slot ISO AC (code, len): table B.5c/d code + sign bit, the
    '11s' special case, or a 20/28-bit escape carrying the TRUE run."""
    sign = lvl < 0
    sbit = sign.to(_I64)
    al = lvl.abs()
    in_range = (run <= tables.AC_MAX_RUN) & (al <= tables.AC_MAX_LEVEL)
    li = run.clamp(0, tables.AC_MAX_RUN) * (tables.AC_MAX_LEVEL + 1) + al.clamp(
        0, tables.AC_MAX_LEVEL
    )
    t_code = ac_code.reshape(-1).to(_I64)[li]
    t_len = torch.where(in_range, ac_len.reshape(-1).to(_I64)[li], 0)
    special = (run == 0) & (al == 1)
    in_table = ~special & (t_len > 0)

    lo = torch.where(sign, (256 - al) & 0xFF, al & 0xFF)
    hi = torch.where(sign, 0x80, 0)
    base = 64 | run
    is_long = al >= 128
    e_code = torch.where(is_long, _shl(base, 16) | _shl(hi, 8) | lo, _shl(base, 8) | lo)
    e_len = torch.where(is_long, 28, 20)

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
    zz = zz.to(_I64)
    nz = zz != 0
    dc = zz[..., 0]
    diff = dc - dc_pred.to(_I64)
    sz = _bitlength8(diff.abs().clamp(0, 255))
    one = torch.ones_like(sz)
    v = torch.where(diff >= 0, diff, diff + _shl(one, sz) - 1)
    dc_bits = v & (_shl(one, sz) - 1)
    ti = is_luma.to(_I64) * dc_code.shape[-1] + sz
    size_code = dc_code.reshape(-1).to(_I64)[ti]
    size_len = dc_len.reshape(-1).to(_I64)[ti]
    code0 = torch.where(sz > 0, _shl(size_code, sz) | dc_bits, size_code)
    len0 = size_len + sz
    first = mb_first.to(torch.bool)
    code0 = torch.where(first, _shl(torch.full_like(len0, 0b11), len0) | code0, code0)
    len0 = len0 + 2 * first.to(_I64)

    ac, ac_l = ac_codes_correct(zz, _runs_forced(zz), ac_code, ac_len)
    ac = torch.where(nz, ac, 0)
    ac_l = torch.where(nz, ac_l, 0)
    lane = torch.arange(64, device=zz.device)
    ac = torch.where(lane == 63, _shl(ac, 2) | 0b10, ac)
    ac_l = torch.where(lane == 63, ac_l + 2, ac_l)
    codes = torch.where(lane == 0, code0[..., None], ac)
    lens = torch.where(lane == 0, len0[..., None], ac_l)
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
