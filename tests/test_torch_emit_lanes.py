"""A plain model of how B6b (`vlc_fused8`) and B6a (`vlc_raw`) map a slice
row onto lanes, held against the twins `cuda_vlc.vlc_fused8_plain` and
`cuda_vlc_raw.vlc_raw_plain`.

The CUDA kernels (`csrc/vlc_fused4.cu`, one template with B1) cannot run
on the CPU, so this file rehearses their control flow with the same
constants (groups of 128 blocks, warps of 32 lanes, a half-warp per block):

* the DCT phase's scatter of each block's zigzag levels into the group's
  swizzled block-major words (`planes_dct.cuh`), conflict-free per warp;
* the cooperative read, a lane per four slots, two blocks per warp pass,
  the pass count of each warp and its group tail;
* `half_warp_run`: the ballot of the lanes that hold a nonzero slot and the
  shuffle from the nearest such lane below, then the lane's own four slots
  (`emit_four_slots`, EOB folded into slot 63);
* B6b: each lane's 4:1 value, the exchange between lanes 2k and 2k+1, the
  8:1 fusion on both and the split stores (even lane words 0-3 and the
  length, odd lane words 4-7), each store instruction 16 consecutive words
  in each of two planes from a 16-word boundary;
* B6a: each slot parked as one word `code | 1 << len` where its level was,
  then the warp's slot-major store, lane t slot k of block g + warp0 + t,
  with the lanes past the group tail masked.

Every output word must be stored exactly once.  The cases: flat planes
(every AC level 0), checkerboards (the last zigzag level nonzero), noise at
q=100 (28- and 20-bit escapes), blocks whose only AC level sits in slot 63
(runs of 62: from planes, and with escapes of both sizes from levels), at
NB = 18, 528 (a half warp in the last group of 16 blocks), 720 and 768 (no
tail).  Tolerance: exact (0).  Nothing in the port imports this model.
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.ops import bitpack, cuda_vlc, cuda_vlc_raw
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import blockize
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.ops.quant import quantize_intra
from ec504_imageencoder_tpu_torch.ops.vlc_device import (
    ac_codes_correct,
    block_streams_correct64,
    dc_predictors,
)
from ec504_imageencoder_tpu_torch.ops.zigzag import zigzag_scan
from ec504_imageencoder_tpu_torch.utils import tables

THREADS, WARP = 128, 32
I64 = torch.int64
LANES = torch.arange(WARP, dtype=I64)
J = LANES & 15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model's tensors are small: one thread spares the pool's cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def swizzle_slot(k):
    return k ^ ((k >> 5) << 1)


def swizzled_word(t, j, i):
    """Word of level 4j + i of the group's block t among its 64."""
    return (4 * j + i) ^ (t & 31) ^ ((j >> 3) << 1)


def _planes(rng, b, h, w, content):
    """4:2:0 planes: "noise", "flat" (one value per frame and plane),
    "checker" (contrast 100..127) or "last" (a checkerboard of contrast
    100..110: at q=5 the AAN DCT leaves only slot 63 nonzero)."""
    out = []
    for s in ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2)):
        if content == "noise":
            p = rng.integers(0, 256, s)
        elif content == "flat":
            p = np.broadcast_to(rng.integers(0, 256, (b, 1, 1)), s)
        else:
            yy, xx = np.indices(s[1:])
            hi = 128 if content == "checker" else 111
            p = 128 + rng.integers(100, hi, (b, 1, 1)) * (((yy + xx) & 1) * 2 - 1)
        out.append(torch.from_numpy(np.ascontiguousarray(p, dtype=np.uint8)))
    return tuple(out)


def _levels(y, cb, cr, qw, luts):
    """The twins' steps up to the emission: zigzag levels (R, NB, 64)
    (slot 0 the absolute DC) and the DC slot's code and length (R, NB)."""
    blocks = blockize(y, cb, cr)
    bsz, mbh = blocks.shape[:2]
    dc, lvl = quantize_intra(aan_dct(blocks), qw)
    zz = zigzag_scan(lvl, luts.zigzag)
    zz = torch.where(torch.arange(64) == 0, dc[..., None], zz).to(I64)
    comp = torch.arange(6)
    codes, lens = block_streams_correct64(
        zz, dc_predictors(dc), (comp < 4).expand(dc.shape), (comp == 0).expand(dc.shape),
        luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len)
    r = bsz * mbh
    return zz.reshape(r, -1, 64), codes[..., 0].reshape(r, -1), lens[..., 0].reshape(r, -1)


def _ac_table(luts):
    """The kernel's s_ac lookup: (code, len), len 0 off the table."""
    code_t, len_t = luts.ac_code.reshape(-1).to(I64), luts.ac_len.reshape(-1).to(I64)

    def table(run, al):
        on = (run < 32) & (al < 41)
        idx = torch.where(on, run * 41 + al, 0)
        return code_t[idx], torch.where(on, len_t[idx], 0)

    return table


def _passes(nb: int):
    """(g, warp0, q) of every warp pass of a row, as the kernel loops."""
    out = []
    for g in range(0, nb, THREADS):
        for warp0 in range(0, THREADS, WARP):
            out += [(g, warp0, q) for q in range(min(16, (nb - g - warp0) // 2))]
    return torch.tensor(out, dtype=I64).reshape(-1, 3)


def _scatter(zz_row, nb: int):
    """The DCT phase: thread tid puts level k of block g + tid at word
    tid * 64 + (swizzle_slot(k) ^ lane) of group g's words."""
    ng = -(-nb // THREADS)
    smem = torch.full((ng, THREADS * 64), -(1 << 40), dtype=I64)  # unwritten
    k = torch.arange(64, dtype=I64)
    for gi in range(ng):
        tid = torch.arange(min(THREADS, nb - gi * THREADS), dtype=I64)[:, None]
        idx = tid * 64 + (swizzle_slot(k) ^ (tid & 31))
        assert idx.unique().numel() == idx.numel()
        # a warp's 32 threads store one k on 32 distinct banks
        for w0 in range(0, tid.shape[0] - WARP + 1, WARP):
            banks = idx[w0:w0 + WARP] % 32
            assert (banks.sort(dim=0).values == torch.arange(32)[:, None]).all()
        smem[gi, idx] = zz_row[gi * THREADS + tid, k]
    return smem


def _half_warp_run(lv):
    """`half_warp_run` for every pass at once: lv (P, 32, 4) -> (P, 32)."""
    slot = 4 * J[:, None] + torch.arange(4)
    last = torch.full(lv.shape[:2], -1, dtype=I64)
    for i in range(4):
        last = torch.where((lv[..., i] != 0) | (slot[:, i] == 0), slot[:, i], last)
    have = ((last >= 0).to(I64) << LANES).sum(dim=1, keepdim=True)  # the ballot
    below = (have >> (LANES & 16)) & ((1 << J) - 1)
    top = torch.zeros_like(below)
    for bit in range(16):
        top = torch.where((below >> bit) & 1 == 1, bit, top)
    src = (LANES & 16) + torch.where(below != 0, top, 0)
    assert (below[:, J > 0] & 1).all()  # lane 0 of the half-warp holds the DC
    prev = last.gather(1, src)  # the shuffle
    return torch.where(J == 0, 0, 4 * J - 1 - prev)


def _emit_four(lv, code0, len0, run, table):
    """`emit_four_slots`: (P, 32, 4) codes and lengths, the run carried
    through the lane's own four slots."""
    c, ln = torch.zeros_like(lv), torch.zeros_like(lv)
    for i in range(4):
        k = 4 * J + i
        nz = lv[..., i] != 0
        code, length = ac_codes_correct(lv[..., i], run, table)
        ci, li = torch.where(nz, code, 0), torch.where(nz, length, 0)
        run = torch.where(nz, 0, run + 1)
        ci = torch.where(k == 63, (ci << 2) | 2, ci)
        li = torch.where(k == 63, li + 2, li)
        c[..., i] = torch.where(k == 0, code0, ci)
        ln[..., i] = torch.where(k == 0, len0, li)
    return c, ln


def _lanes(zz_row, code0_row, len0_row, nb, table):
    """Scatter, cooperative read and emission of one row: the pass table
    (P, 3), the group words, the read addresses (P, 32, 4), the lanes'
    blocks n (P, 32) and their slots' codes and lengths (P, 32, 4)."""
    smem = _scatter(zz_row, nb)
    ps = _passes(nb)
    g, warp0, q = ps[:, :1], ps[:, 1:2], ps[:, 2:]
    t = warp0 + 2 * q + (LANES >> 4)
    n = g + t
    assert (n < nb).all()
    widx = t[..., None] * 64 + swizzled_word(t[..., None], J[:, None], torch.arange(4))
    # the cooperative read: four loads, each on 32 distinct banks
    for i in range(4):
        assert ((widx[..., i] % 32).sort(dim=1).values == torch.arange(32)).all()
    lv = smem[g // THREADS, widx.reshape(len(ps), -1)].reshape(widx.shape)
    assert (lv > -(1 << 40)).all()
    code0 = torch.where(J == 0, code0_row[n], 0)
    len0 = torch.where(J == 0, len0_row[n], 0)
    c, ln = _emit_four(lv, code0, len0, _half_warp_run(lv), table)
    return ps, smem, widx, n, c, ln


def model_fused8(zz, code0, len0, table):
    """B6b: (words (8 planes of (R, NB * 8)), flens), each word stored once."""
    r, nb = code0.shape
    kf = nb * 8
    out = torch.zeros((9, r * kf), dtype=I64)
    count = torch.zeros_like(out)
    odd = (LANES & 1).bool()
    for row in range(r):
        _, _, _, n, c, ln = _lanes(zz[row], code0[row], len0[row], nb, table)
        v0, v1, v2, v3, flen = (x[..., 0] for x in bitpack.fuse4(c, ln))
        v = torch.stack([v0, v1, v2, v3], dim=-1)
        partner = LANES ^ 1
        p, plen = v[:, partner], flen[:, partner]  # __shfl_xor_sync(..., 1)
        a = torch.where(odd[:, None], p, v)
        b = torch.where(odd[:, None], v, p)
        la, lb = torch.where(odd, plen, flen), torch.where(odd, flen, plen)
        words, _ = bitpack.fuse8(*(torch.stack([a[..., i], b[..., i]], dim=-1)
                                   for i in range(4)), torch.stack([la, lb], dim=-1))
        w = torch.stack([x[..., 0] for x in words], dim=-1)  # (P, 32, 8)
        o = row * kf + n * 8 + (J >> 1)
        for i in range(4):  # one store instruction each
            plane = torch.where(odd, 4 + i, i)
            addr = plane * r * kf + o
            for half in (~odd, odd):
                run16 = addr[:, half].sort(dim=1).values
                assert (run16 == run16[:, :1] + torch.arange(16)).all()
                assert (run16[:, 0] % 16 == 0).all()
            val = torch.where(odd, w[..., 4 + i], w[..., i])
            out[plane, o] = val
            count[plane, o] += 1
        out[8, o[:, ~odd]] = (la + lb)[:, ~odd]
        count[8, o[:, ~odd]] += 1
    assert (count == 1).all()
    return tuple(out[i].reshape(r, kf) for i in range(8)), out[8].reshape(r, kf)


def model_raw(zz, code0, len0, table):
    """B6a: codes and lens (R, 64, NB), each word stored once."""
    r, nb = code0.shape
    codes = torch.zeros((r, 64, nb), dtype=I64)
    lens = torch.zeros_like(codes)
    count = torch.zeros_like(codes)
    k = torch.arange(64, dtype=I64)
    for row in range(r):
        ps, smem, widx, n, c, ln = _lanes(zz[row], code0[row], len0[row], nb, table)
        assert (ln <= 30).all() and (c < (1 << ln)).all()
        gi = (ps[:, 0] // THREADS)[:, None]
        flat = widx.reshape(len(ps), -1)
        # each lane writes back exactly the words it read, one per slot
        assert all(f.unique().numel() == 128 for f in flat)
        smem[gi, flat] = (c | (1 << ln)).reshape(len(ps), -1)
        parked = torch.zeros_like(smem)
        parked[gi, flat] += 1
        for g in range(0, nb, THREADS):
            live = min(THREADS, nb - g) * 64
            assert (parked[g // THREADS, :live] == 1).all()
            assert not parked[g // THREADS, live:].any()
            for warp0 in range(0, THREADS, WARP):
                t = torch.arange(WARP, dtype=I64)
                nn = g + warp0 + t
                keep = nn < nb  # the group tail
                if not keep.any():
                    continue
                # slot k of block warp0 + t: lane t's own block, bank swizzle_slot(k) ^ t
                addr = (warp0 + t)[:, None] * 64 + (swizzle_slot(k)[None] ^ t[:, None])
                assert ((addr % 32).sort(dim=0).values == t[:, None]).all()
                word = smem[g // THREADS, addr][keep]
                length = torch.floor(torch.log2(word.double())).to(I64)  # 31 - clz
                codes[row, :, nn[keep]] = (word ^ (1 << length)).T
                lens[row, :, nn[keep]] = length.T
                count[row, :, nn[keep]] += 1
    assert (count == 1).all()
    return codes, lens


PLANE_CASES = {
    "flat NB=528 q=50": ("flat", (1, 16, 1408), 50),
    "checker NB=528 q=100": ("checker", (1, 16, 1408), 100),
    "noise NB=18 q=100": ("noise", (2, 16, 48), 100),
    "noise NB=528 q=100": ("noise", (1, 16, 1408), 100),
    "noise NB=720 q=50": ("noise", (1, 16, 1920), 50),
    "noise NB=768 q=69": ("noise", (1, 16, 2048), 69),
    "last slot only NB=528 q=5": ("last", (1, 16, 1408), 5),
}


def _plane_case(name):
    content, shape, q = PLANE_CASES[name]
    core = TorchMPEG1IntraEncoder(quality=q, dct_impl="aan", device="cpu").core
    planes = _planes(np.random.default_rng(sum(shape) + q), *shape, content)
    luts = core.luts()
    zz, code0, len0 = _levels(*planes, core.qw, luts)
    ac = zz[..., 1:]
    if content == "flat":
        assert not ac.any()
    elif content == "checker":
        assert ac[..., 62].all()
    elif content == "last":
        assert not ac[..., :62].any() and ac[..., 62].all()
    elif q == 100:
        assert (ac.abs() >= 128).any() and ((ac.abs() < 128) & (ac != 0)).any()
    return planes, core.qw, luts, zz, code0, len0


def _last_slot_levels(nb: int, rows: int = 1):
    """Blocks whose only AC level sits in slot 63 (a run of 62), of every
    size class: the 20-bit escape (|level| < 128) and the 28-bit one, both
    signs; the DC slots of random DCs."""
    rng = np.random.default_rng(nb)
    core = TorchMPEG1IntraEncoder(quality=50, dct_impl="aan", device="cpu").core
    luts = core.luts()
    zz = torch.zeros((rows, nb, 64), dtype=I64)
    mags = torch.tensor([1, 2, 40, 127, 128, 200, 255], dtype=I64)
    pick = torch.from_numpy(rng.integers(0, len(mags), (rows, nb)))
    sign = torch.from_numpy(rng.integers(0, 2, (rows, nb))) * 2 - 1
    zz[..., 63] = mags[pick] * sign
    zz[..., 0] = torch.from_numpy(rng.integers(0, 256, (rows, nb)))
    dc = zz[..., 0].reshape(rows, 1, nb // 6, 6)
    comp = torch.arange(6)
    codes, lens = block_streams_correct64(
        zz.reshape(rows, 1, nb // 6, 6, 64), dc_predictors(dc), (comp < 4).expand(dc.shape),
        (comp == 0).expand(dc.shape), luts.dc_code, luts.dc_len, luts.ac_code, luts.ac_len)
    codes, lens = codes.reshape(rows, nb, 64), lens.reshape(rows, nb, 64)
    assert set(lens[..., 63].unique().tolist()) == {30, 22}  # escapes + EOB
    return zz, codes, lens, luts


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_fused8_lanes_match_twin(case):
    planes, qw, luts, zz, code0, len0 = _plane_case(case)
    words, flens = model_fused8(zz, code0, len0, _ac_table(luts))
    want_w, want_l = cuda_vlc.vlc_fused8_plain(*planes, qw, luts)
    assert torch.equal(flens, want_l.to(I64))
    for got, want in zip(words, want_w):
        assert torch.equal(cuda_vlc.to_i32_bits(got), want)


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_raw_lanes_match_twin(case):
    planes, qw, luts, zz, code0, len0 = _plane_case(case)
    codes, lens = model_raw(zz, code0, len0, _ac_table(luts))
    want_c, want_l, _ = cuda_vlc_raw.vlc_raw_plain(*planes, qw, luts)
    assert torch.equal(cuda_vlc.to_i32_bits(codes), want_c)
    assert torch.equal(lens, want_l.to(I64))


@pytest.mark.parametrize("nb", [18, 528])
def test_lanes_on_runs_of_62_with_escapes(nb):
    """Levels made directly: slot 63 alone, 20- and 28-bit escapes of run
    62; held against the twins' emission and fusion of the same levels."""
    zz, codes, lens, luts = _last_slot_levels(nb)
    table = _ac_table(luts)
    words, flens = model_fused8(zz, codes[..., 0], lens[..., 0], table)
    want_w, want_l = bitpack.fuse8(*bitpack.fuse4(codes.reshape(1, -1), lens.reshape(1, -1)))
    assert torch.equal(flens, want_l)
    for got, want in zip(words, want_w):
        assert torch.equal(got, want)
    raw_c, raw_l = model_raw(zz, codes[..., 0], lens[..., 0], table)
    assert torch.equal(raw_c, codes.transpose(1, 2)) and torch.equal(raw_l, lens.transpose(1, 2))


def test_slot_word_holds_every_slot_of_the_tables():
    """B6a's one-word slot `code | 1 << len` is exact: no table code has a
    bit at or above its length, and no slot is longer than 30 bits."""
    for code, length in ((tables.AC_CODE_T, tables.AC_LEN_T), (tables.DC_CODE_T, tables.DC_LEN_T)):
        code, length = code.to(I64), length.to(I64)
        assert (code[length > 0] < (1 << length[length > 0])).all()
        assert (length <= 16).all()
    planes, qw, luts, *_ = _plane_case("noise NB=18 q=100")
    codes, lens, _ = cuda_vlc.block_slots(*planes, qw, luts)
    assert lens.max() == 30 and (codes < (1 << lens)).all()
