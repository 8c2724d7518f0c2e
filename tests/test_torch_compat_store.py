"""A plain model of B4a (`vlc_compat_slots`) on B4b's flat groups, held
against the twin `cuda_vlc_compat.vlc_compat_slots_plain` and the
reference's `_vlc_compat_kernel` in interpret mode; and the exactness of
the compat DCT phase's division (`csrc/vlc_compat.cu::compat_div`).

The CUDA kernel cannot run on the CPU, so this file rehearses its control
flow with its constants (B4b's lanes are modelled by
`test_torch_compat_lanes.compat_lanes`):

* the flat block g = 128 b + tid of thread tid of CUDA block b, its levels
  scattered into the group's swizzled words, two blocks per warp pass, the
  pass count of each warp and the short last group (324 blocks a frame: 1
  frame leaves a last group of 68, 2 of 8, 3 of 76, 30 of 120);
* each lane's four slots parked as one word each, `code | 1 << len`
  (`slot_word`), in the words their levels came from;
* the slot-major store: lane t stores slot k of the warp's block t at
  (row * 64 + k) * 54 + n.  Every word must be stored exactly once, and
  each store instruction (a warp, one k) must write at most two runs of
  consecutive words, since a warp's 32 flat blocks span at most two slice
  rows.

Mutations of the model (the slice row of the warp's first block used for
every lane, the park without the swizzle, the park without the length
marker) each fail.  The division: for every divisor that
`scale_quantization_matrix` gives at quality 1..100 and every numerator
|x| < 2^15, the multiply-high by 2^31 / d + 1 equals C's truncating `/`;
the AAN DCT of 8-bit pixels stays below 2^14 in magnitude.  Tolerance:
exact (0).  Nothing in the port imports this model.
"""

import numpy as np
import pytest
import torch
from test_torch_compat_lanes import (
    GROUP,
    I64,
    LANES,
    LEVEL_PATTERNS,
    NB,
    UNWRITTEN,
    WARP,
    J,
    _made_levels,
    _twin_emission,
    compat_lanes,
    swizzle_slot,
    swizzled_word,
)
from test_torch_vlc import _compat_planes, _emits_typo_pair

from ec504_imageencoder_tpu.models.encoder import compat_blockize_px64
from ec504_imageencoder_tpu.ops.pallas_vlc import vlc_compat_slots_from_blocks_tpu
from ec504_imageencoder_tpu_torch.ops import cuda_vlc_compat
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts, to_i32_bits
from ec504_imageencoder_tpu_torch.ops.dct import aan_dct
from ec504_imageencoder_tpu_torch.utils.tables import scale_quantization_matrix

MUTATIONS = ("row-of-warp", "park-unswizzled", "park-without-marker")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model's tensors are small: one thread spares the pool's cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(addr) -> torch.Tensor:
    """(P, 32) addresses of one store instruction each -> (P,) the number
    of runs of consecutive words they form."""
    a = addr.sort(dim=1).values
    return 1 + (a[:, 1:] != a[:, :-1] + 1).sum(dim=1)


def model_raw(zz, code0, len0, luts, mutation=None, chunk_groups=96):
    """B4a: zz (nblk, 64) levels of the flat blocks, code0 / len0 (nblk,)
    their DC slots -> (codes, lens), each (nblk / 54, 64, 54) int64, every
    word stored once."""
    nblk = zz.shape[0]
    codes = torch.full((nblk * 64,), UNWRITTEN, dtype=I64)
    lens = torch.full_like(codes, UNWRITTEN)
    count = torch.zeros_like(codes)
    k = torch.arange(64, dtype=I64)
    ngroups = -(-nblk // GROUP)
    for c0 in range(0, ngroups, chunk_groups):
        gis = range(c0, min(c0 + chunk_groups, ngroups))
        smem = torch.full((len(gis), GROUP * 64), UNWRITTEN, dtype=I64)
        passes, threads = [], []
        for local, gi in enumerate(gis):
            g0 = gi * GROUP
            tid = torch.arange(min(GROUP, nblk - g0), dtype=I64)
            # the DCT phase: level k of block g0 + tid at tid * 64 + (swizzle_slot(k) ^ lane)
            smem[local, tid[:, None] * 64 + (swizzle_slot(k) ^ (tid[:, None] & 31))] = \
                zz[g0 + tid[:, None], k]
            for warp0 in range(0, GROUP, WARP):
                left = nblk - g0 - warp0
                assert left <= 0 or left % 2 == 0  # both half-warps of a pass hold a block
                passes += [(local, g0, warp0, q) for q in range(min(16, left // 2))]
                if left > 0:
                    threads.append((local, g0, warp0))
        # the emission: lane j of the pass's block t parks its four slots
        ps = torch.tensor(passes, dtype=I64).reshape(-1, 4)
        local, g0, warp0, q = (ps[:, i:i + 1] for i in range(4))
        t = warp0 + 2 * q + (LANES >> 4)
        g = g0 + t
        widx = t[..., None] * 64 + swizzled_word(t[..., None], J[:, None], torch.arange(4))
        lv = smem[local[..., None], widx]
        assert (lv > UNWRITTEN).all()
        c, ln = compat_lanes(lv, torch.where(J == 0, code0[g], 0),
                             torch.where(J == 0, len0[g], 0), luts)
        assert ((c >> ln) == 0).all() and (ln <= 30).all()  # slot_word is exact
        word = c if mutation == "park-without-marker" else c | (1 << ln)
        if mutation == "park-unswizzled":
            widx = t[..., None] * 64 + 4 * J[:, None] + torch.arange(4)
        smem[local[..., None], widx] = word
        # the store: lane t of each warp, slot k of its own block, per k
        ws = torch.tensor(threads, dtype=I64).reshape(-1, 3)
        local, g0, warp0 = (ws[:, i:i + 1] for i in range(3))
        tw = warp0 + LANES
        g = g0 + tw
        live = g < nblk  # a short last group: lanes past the batch store nothing
        row = g // NB
        if mutation == "row-of-warp":
            row = (g0 + warp0) // NB
        n = g - NB * row
        for kk in range(64):
            w = smem[local, tw * 64 + (swizzle_slot(kk) ^ (tw & 31))]
            length = torch.where(w > 0, torch.floor(torch.log2(w.clamp(min=1).double())), 0).long()
            addr = (row * 64 + kk) * NB + n
            # lanes past the batch (a prefix is live) continue the last run
            last = torch.where(live, addr, -1).max(dim=1, keepdim=True).values
            runs = _runs(torch.where(live, addr, last + 1 + LANES - live.sum(1, keepdim=True)))
            assert (runs <= 2).all(), "a store instruction writes at most two runs"
            a, live_w, length = addr[live], w[live], length[live]
            codes[a] = live_w ^ (1 << length)
            lens[a] = length
            count[a] += 1
    assert (count == 1).all(), "every output word is stored exactly once"
    r = nblk // NB
    return codes.view(r, 64, NB), lens.view(r, 64, NB)


def _check(got, want):
    gc, gl = got
    wc, wl = want
    assert torch.equal(to_i32_bits(gc), wc) and torch.equal(gl.to(torch.int32), wl)


def _planes(content, frames, h, w, seed):
    rng = np.random.default_rng(seed)
    if content == "flat":
        arrays = [np.broadcast_to(rng.integers(0, 256, (frames, 1, 1)), (frames, h, w))
                  for _ in range(3)]
    elif content == "checker":
        yy, xx = np.indices((h, w))
        arrays = [128 + rng.integers(100, 128, (frames, 1, 1)) * (((yy + xx) & 1) * 2 - 1)
                  for _ in range(3)]
    else:
        arrays = [rng.integers(0, 256, (frames, h, w)) for _ in range(3)]
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)) for a in arrays)


# (content, frames, height, width, quality): batch 1 (a last group of 68),
# the widths of chip_smoke.py's compat frames and around them (W % 8 != 0
# at 601, 602 and 610), odd sizes, escapes at q=100
PLANE_CASES = {
    "noise q=12, 1 frame, 144x96": ("noise", 1, 144, 96, 12),
    "noise q=1, 2 frames, 150x600": ("noise", 2, 150, 600, 1),
    "checker q=100, 2 frames, 150x601": ("checker", 2, 150, 601, 100),
    "noise q=50, 3 frames, 151x602": ("noise", 3, 151, 602, 50),
    "flat q=12, 30 frames, 144x610": ("flat", 30, 144, 610, 12),
    "noise q=100, 30 frames, 150x101": ("noise", 30, 150, 101, 100),
}


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_compat_store_matches_twin(case):
    content, frames, h, w, quality = PLANE_CASES[case]
    planes = _planes(content, frames, h, w, frames * w + quality)
    luts = Luts.compat("cpu")
    sq = torch.from_numpy(scale_quantization_matrix(quality).astype(np.int32))
    zz = cuda_vlc_compat.compat_levels(*planes, sq, luts)
    _, zl, code0, len0 = _twin_emission(zz, luts)
    want = cuda_vlc_compat.vlc_compat_slots_plain(*planes, sq, luts)
    _check(model_raw(zl, code0, len0, luts), want)


@pytest.mark.parametrize("frames", [1, 3, 30])
@pytest.mark.parametrize("pattern", LEVEL_PATTERNS)
def test_compat_store_on_made_levels(pattern, frames):
    zz = _made_levels(pattern, frames, len(pattern) * 17 + frames)
    luts = Luts.compat("cpu")
    _, zl, code0, len0 = _twin_emission(zz, luts)
    codes, lens = cuda_vlc_compat.stream_slots(zz, luts)
    want = (to_i32_bits(codes.transpose(1, 2)), lens.transpose(1, 2).to(torch.int32))
    _check(model_raw(zl, code0, len0, luts), want)


def test_compat_store_matches_the_pallas_kernel():
    """The model against `vlc_compat_slots_from_blocks_tpu(interpret=True)`
    on test_torch_vlc's compat planes (2 frames of 150 x 101, q=12: noise,
    and ramps with a 28-bit escape), which avoid (run 16, |level| 2): there
    the reference's Pallas kernels read the ISO row (ROADMAP C-r5).
    Lengths exact, codes exact below their length."""
    rng = np.random.default_rng(12 + 101)
    y, cb, cr = _compat_planes(rng, 150, 101)
    scaled_q = scale_quantization_matrix(12).astype(np.int32)
    assert not _emits_typo_pair(y, cb, cr, scaled_q)
    luts = Luts.compat("cpu")
    zz = cuda_vlc_compat.compat_levels(*(torch.from_numpy(p) for p in (y, cb, cr)),
                                       torch.from_numpy(scaled_q), luts)
    _, zl, code0, len0 = _twin_emission(zz, luts)
    got_c, got_l = model_raw(zl, code0, len0, luts)
    codes, lens = vlc_compat_slots_from_blocks_tpu(compat_blockize_px64(y, cb, cr, np), scaled_q,
                                                   interpret=True)
    want_l = np.asarray(lens)
    assert np.array_equal(got_l.numpy(), want_l)
    mask = ((1 << np.clip(want_l, 0, 31).astype(np.uint64)) - 1).astype(np.uint32)
    assert np.array_equal(to_i32_bits(got_c).numpy().view(np.uint32), np.asarray(codes) & mask)


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutated_store_models_fail(mutation):
    """Each mutation fails on 3 frames of made levels (a warp spans two
    slice rows; slots of every length)."""
    zz = _made_levels("sparse", 3, 5)
    luts = Luts.compat("cpu")
    _, zl, code0, len0 = _twin_emission(zz, luts)
    codes, lens = cuda_vlc_compat.stream_slots(zz, luts)
    want = (to_i32_bits(codes.transpose(1, 2)), lens.transpose(1, 2).to(torch.int32))
    try:
        got = model_raw(zl, code0, len0, luts, mutation=mutation)
    except AssertionError:
        return  # the model's own store checks caught it
    with pytest.raises(AssertionError):
        _check(got, want)


# ---- compat_div: C's `/` by a multiply-high --------------------------------

def _compat_div(x: np.ndarray, d: int) -> np.ndarray:
    """compat_div in int64: umulhi(2|x|, 2^31 / d + 1), the sign of x."""
    m = (1 << 31) // d + 1
    assert 0 < m < 1 << 32
    k = ((2 * np.abs(x)) * m) >> 32
    return np.where(x < 0, -k, k)


def test_compat_div_equals_c_division():
    """Every numerator |x| < 2^15 by every divisor of the scaled matrices
    at quality 1..100 (and 1..64, and the largest the kernel serves)."""
    ds = np.unique(np.concatenate([scale_quantization_matrix(q).ravel() for q in range(1, 101)]
                                  + [np.arange(1, 65), [65535]]))
    assert ds.min() >= 1 and ds.max() <= 65535
    x = np.arange(-(1 << 15) + 1, 1 << 15, dtype=np.int64)
    for d in ds.tolist():
        want = np.sign(x) * (np.abs(x) // d)  # C's `/`: truncation toward zero
        assert np.array_equal(_compat_div(x, d), want), d
    # the kernel's torch twin divides with torch.div(rounding_mode="trunc")
    t = torch.from_numpy(x.astype(np.int32))
    for d in (1, 3, 77, 4150):
        assert np.array_equal(torch.div(t, d, rounding_mode="trunc").numpy(), _compat_div(x, d))


def test_compat_dct_of_8bit_pixels_stays_below_2_pow_14():
    """compat_div's numerators: the AAN DCT (ops/dct.py, the kernels'
    twin) of every block that maximises or minimises one coefficient of
    its linear part (pixels 0 or 255 by the sign of the coefficient's
    impulse response), of random 0/255 blocks and of uniform noise."""
    eye = torch.eye(64, dtype=torch.int32).reshape(64, 8, 8) * 255
    resp = aan_dct(eye).reshape(64, 64)  # [pixel, coefficient]
    ext = torch.cat([(resp > 0).T, (resp < 0).T]).to(torch.int32).reshape(-1, 8, 8) * 255
    rng = np.random.default_rng(14)
    rand = torch.from_numpy(rng.integers(0, 2, (20000, 8, 8)).astype(np.int32) * 255)
    noise = torch.from_numpy(rng.integers(0, 256, (20000, 8, 8)).astype(np.int32))
    top = max(int(aan_dct(b).abs().max()) for b in (ext, rand, noise))
    assert 2000 < top < 1 << 14
