"""A plain model of how B4b (`vlc_compat_fused4`) maps compat blocks onto
lanes, held against the twin `cuda_vlc_compat.vlc_compat_fused4_plain`
(and, for levels made directly, against the twin's emission
`stream_slots` and `bitpack.fuse4`).

The CUDA kernel (`csrc/vlc_compat.cu`) cannot run on the CPU, so this file
rehearses its control flow with the same constants (flat groups of 128
blocks, warps of 32 lanes, a half-warp per block):

* the flat block g = 128 b + tid of thread tid of CUDA block b: its slice
  row, block, frame and band, and its pixels at `compat_origin`'s offsets
  (luma, and chroma's half-stride view, quirk Q3), held against
  `compat_blockize`;
* the DCT phase's scatter of each block's levels into the group's swizzled
  words (`planes_dct.cuh`), the cooperative read, two blocks per warp pass,
  the pass count of each warp and the group tail (324 blocks a frame: 1
  frame leaves a last group of 68, 30 frames one of 120, 480 frames none);
* `compat_lane_slots`: the ballot of the lanes holding a nonzero slot (the
  DC only if it is nonzero) and the shuffle from the nearest one below (run
  = 4j - 1 - p); the Q5 triggers (a nonzero slot after a nonzero one, for
  the lane's first slot lane j - 1's slot 3 by a shuffle up) and their
  ballot; the lane's four slots in order with emit_ac_compat's carry (run
  index zb - 1), EOB folded into slot 63 also when it is dropped;
* the stores: lane j of block g at fused slot g * 16 + j, each store
  instruction 32 consecutive words from a 32-word boundary.

Every output word must be stored exactly once.  Mutations of the model
(the DC counted as always nonzero, the drop pair read within a lane only,
no drop handed up from lower lanes, no EOB on a dropped slot 63) each fail
one of the cases.  Tolerance: exact (0).  Nothing in the port imports this
model.
"""

import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu_torch.ops import bitpack, cuda_vlc_compat
from ec504_imageencoder_tpu_torch.ops.cuda_vlc import Luts, to_i32_bits
from ec504_imageencoder_tpu_torch.ops.vlc_device import ac_codes_compat
from ec504_imageencoder_tpu_torch.utils.tables import scale_quantization_matrix

GROUP, WARP = 128, 32
NB = cuda_vlc_compat.NB  # blocks per slice row
I64 = torch.int64
LANES = torch.arange(WARP, dtype=I64)
J = LANES & 15
UNWRITTEN = -(1 << 40)
MUTATIONS = ("dc-always-nonzero", "pair-within-lane", "no-drop-from-below", "no-eob-when-dropped")


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


def origins(nblk: int, h: int, w: int):
    """`compat_origin` of every flat block g: (plane (nblk,): 0 y, 1 cb,
    2 cr; flat pixel index (nblk, 8, 8) into the frames' (B * H * W,)
    plane)."""
    g = torch.arange(nblk, dtype=I64)
    row, n = g // NB, g % NB
    b, s = row // 6, row % 6
    mb, comp = n // 6, n % 6
    r = torch.arange(8, dtype=I64)[:, None]
    c = torch.arange(8, dtype=I64)
    frame = (b * h * w)[:, None, None]
    luma = ((16 * mb + 8 * (comp >> 1))[:, None, None] + r) * w + (16 * s + 8 * (comp & 1))[:, None, None] + c
    half = w // 2
    chroma = ((8 * mb)[:, None, None] + r) * half + (8 * s)[:, None, None] + c
    return torch.where(comp < 4, 0, comp - 3), frame + torch.where(comp[:, None, None] < 4, luma, chroma)


def _ballot(pred):
    """(P, 32) bool -> (P, 1) the warp's ballot bits."""
    return (pred.to(I64) << LANES).sum(dim=1, keepdim=True)


def _highest_bit(bits):
    top = torch.zeros_like(bits)
    for bit in range(16):
        top = torch.where((bits >> bit) & 1 == 1, bit, top)
    return top


def compat_lanes(lv, code0, len0, luts, mutation=None):
    """`compat_lane_slots` for every pass at once: lv (P, 32, 4) levels
    (lv[..., 0] of lane 0 the DC), code0 / len0 (P, 32) the DC slot on lane
    0 -> codes and lengths (P, 32, 4)."""
    slot = 4 * J[:, None] + torch.arange(4)
    nz = lv != 0
    if mutation == "dc-always-nonzero":
        nz = nz | (slot == 0)
    last = torch.where(nz, slot, -1).max(dim=-1).values
    # __shfl_up_sync(lv[3] != 0, 1): lane L reads lane L - 1; j = 0 has none
    prev_nz = nz[..., 3].roll(1, dims=1) & (J > 0)
    if mutation == "pair-within-lane":
        prev_nz = torch.zeros_like(prev_nz)
    trig = torch.zeros_like(prev_nz)
    for i in range(4):
        trig = trig | (nz[..., i] & prev_nz)
        prev_nz = nz[..., i]
    below = (1 << J) - 1
    have = (_ballot(last >= 0) >> (LANES & 16)) & below
    src = (LANES & 16) + _highest_bit(have)
    prev = last.gather(1, src)  # the shuffle
    run = 4 * J - 1 - torch.where(have != 0, prev, -1)
    dropped = ((_ballot(trig) >> (LANES & 16)) & below) != 0
    if mutation == "no-drop-from-below":
        dropped = torch.zeros_like(dropped)
    c, ln = torch.zeros_like(lv), torch.zeros_like(lv)
    for i in range(4):
        k = 4 * J + i
        lvl = lv[..., i]
        nzi = nz[..., i]
        is_dc = k == 0
        # emit_ac_compat: zb = run, run = 0 on a nonzero level, else run + 1;
        # a run of 0 before a nonzero level drops it and everything after
        zb = run
        run = torch.where(is_dc, (~nzi).to(I64), torch.where(nzi, 0, run + 1))
        dropped = dropped | (nzi & (zb == 0) & ~is_dc)
        emit = nzi & ~dropped
        code, length = ac_codes_compat(lvl, zb, luts.ac_code, luts.ac_len)
        ci = torch.where(is_dc, code0, torch.where(emit, code, 0))
        li = torch.where(is_dc, len0, torch.where(emit, length, 0))
        eob = k == 63
        if mutation == "no-eob-when-dropped":
            eob = eob & emit
        c[..., i] = torch.where(eob, (ci << 2) | 2, ci)
        ln[..., i] = torch.where(eob, li + 2, li)
    return c, ln


def model_fused4(zz, code0, len0, luts, mutation=None, chunk_groups=96):
    """B4b: zz (nblk, 64) levels of the flat blocks, code0 / len0 (nblk,)
    their DC slots -> (v0, v1, v2, v3, flens), each (nblk / 54, 54 * 16),
    every word stored once."""
    nblk = zz.shape[0]
    out = torch.zeros((5, nblk * 16), dtype=I64)
    count = torch.zeros_like(out)
    k = torch.arange(64, dtype=I64)
    ngroups = -(-nblk // GROUP)
    for c0 in range(0, ngroups, chunk_groups):
        gis = range(c0, min(c0 + chunk_groups, ngroups))
        smem = torch.full((len(gis), GROUP * 64), UNWRITTEN, dtype=I64)
        passes = []
        for local, gi in enumerate(gis):
            g0 = gi * GROUP
            # DCT phase: thread tid, block g0 + tid, level k at word
            # tid * 64 + (swizzle_slot(k) ^ lane)
            tid = torch.arange(min(GROUP, nblk - g0), dtype=I64)[:, None]
            idx = tid * 64 + (swizzle_slot(k) ^ (tid & 31))
            smem[local, idx] = zz[g0 + tid, k]
            for warp0 in range(0, GROUP, WARP):
                left = nblk - g0 - warp0
                assert left <= 0 or left % 2 == 0  # both half-warps of a pass hold a block
                passes += [(local, g0, warp0, q) for q in range(min(16, left // 2))]
        ps = torch.tensor(passes, dtype=I64).reshape(-1, 4)
        local, g0, warp0, q = (ps[:, i:i + 1] for i in range(4))
        t = warp0 + 2 * q + (LANES >> 4)
        g = g0 + t
        assert (g < nblk).all()
        widx = t[..., None] * 64 + swizzled_word(t[..., None], J[:, None], torch.arange(4))
        lv = smem[local[..., None], widx]
        assert (lv > UNWRITTEN).all()
        c0_, l0_ = torch.where(J == 0, code0[g], 0), torch.where(J == 0, len0[g], 0)
        c, ln = compat_lanes(lv, c0_, l0_, luts, mutation)
        fused = [x[..., 0] for x in bitpack.fuse4(c, ln)]
        o = g * 16 + J
        run32 = o.sort(dim=1).values  # one store instruction: 32 words in a row
        assert (run32 == run32[:, :1] + LANES).all() and (run32[:, 0] % 32 == 0).all()
        for p in range(5):
            out[p, o] = fused[p]
            count[p, o] += 1
    assert (count == 1).all(), "every output word is stored exactly once"
    return tuple(out[p].reshape(nblk // NB, NB * 16) for p in range(5))


def _twin_emission(zz, luts):
    """The twin's fused slots of levels zz (B, 6, 9, 6, 64), and the flat
    levels and DC slots the model takes."""
    codes, lens = cuda_vlc_compat.stream_slots(zz, luts)
    r = codes.shape[0]
    want = tuple(to_i32_bits(t) for t in bitpack.fuse4(codes.reshape(r, -1), lens.reshape(r, -1)))
    return want, zz.reshape(-1, 64).to(I64), codes[..., 0].reshape(-1), lens[..., 0].reshape(-1)


def _check(got, want):
    for gw, w in zip(got, want):
        assert torch.equal(to_i32_bits(gw), w)


# (content, frames, height, width, quality): 324 blocks a frame, so 1
# frame leaves a last group of 68 blocks, 30 frames one of 120, 480 none
PLANE_CASES = {
    "noise q=1, 1 frame": ("noise", 1, 144, 96, 1),
    "noise q=12, 30 frames, odd W": ("noise", 30, 150, 101, 12),
    "noise q=50, 2 frames": ("noise", 2, 150, 100, 50),
    "noise q=100, 1 frame, odd W": ("noise", 1, 151, 97, 100),
    "flat q=12, 30 frames": ("flat", 30, 144, 96, 12),
    "noise q=12, 480 frames": ("noise", 480, 144, 96, 12),
}


def _planes(content, frames, h, w, seed):
    rng = np.random.default_rng(seed)
    if content == "flat":
        return tuple(torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            rng.integers(0, 256, (frames, 1, 1), dtype=np.uint8), (frames, h, w))))
            for _ in range(3))
    return tuple(torch.from_numpy(rng.integers(0, 256, (frames, h, w), dtype=np.uint8))
                 for _ in range(3))


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_compat_lanes_match_twin(case):
    content, frames, h, w, quality = PLANE_CASES[case]
    planes = _planes(content, frames, h, w, frames * w + quality)
    luts = Luts.compat("cpu")
    sq = torch.from_numpy(scale_quantization_matrix(quality).astype(np.int32))
    nblk = frames * 6 * NB
    assert nblk % GROUP == {1: 68, 2: 8, 30: 120, 480: 0}[frames]
    plane, idx = origins(nblk, h, w)
    px = torch.stack([p.reshape(-1) for p in planes])[plane[:, None, None], idx]
    assert torch.equal(px, cuda_vlc_compat.compat_blockize(*planes).reshape(nblk, 8, 8))
    # 32 frames (10,368 blocks, 81 groups) at a time keep the twin small;
    # the model still walks the whole batch's groups
    step = 32
    levels, code0, len0, want = [], [], [], []
    for f0 in range(0, frames, step):
        chunk = tuple(p[f0:f0 + step] for p in planes)
        zz = cuda_vlc_compat.compat_levels(*chunk, sq, luts)
        if content == "flat":
            assert not zz[..., 1:].any()
        fused, zl, c0, l0 = _twin_emission(zz, luts)
        assert all(torch.equal(a, b) for a, b in zip(
            fused, cuda_vlc_compat.vlc_compat_fused4_plain(*chunk, sq, luts)))
        levels.append(zl), code0.append(c0), len0.append(l0), want.append(fused)
    got = model_fused4(torch.cat(levels), torch.cat(code0), torch.cat(len0), luts)
    _check(got, tuple(torch.cat(parts) for parts in zip(*want)))


def _made_levels(pattern: str, frames: int, seed: int):
    """(frames, 6, 9, 6, 64) levels made directly, every block a case of
    `pattern`: "dc0-lv1" (DC 0, slot 1 nonzero: no drop), "dc-lv1" (DC and
    slot 1 nonzero: the drop at k = 1), "pair-across-lanes" (slots 4j - 1
    and 4j nonzero, j in 1..15: the drop at 4j, across two lanes, with
    nonzero slots after it and isolated ones before), "last-only" (only
    slot 63, runs of 62 and 63: escapes of both sizes) or "sparse"
    (random, 70% zeros, magnitudes up to 300)."""
    rng = np.random.default_rng(seed)
    nblk = frames * 6 * NB
    zz = np.zeros((nblk, 64), np.int64)
    sign = lambda n: rng.choice([-1, 1], n)  # noqa: E731
    dc = rng.integers(1, 256, nblk) * sign(nblk)
    dc[rng.random(nblk) < 0.3] = 0
    if pattern == "sparse":
        zz[:, 1:] = rng.integers(1, 301, (nblk, 63)) * rng.choice([-1, 1], (nblk, 63))
        zz[:, 1:][rng.random((nblk, 63)) < 0.7] = 0
    elif pattern in ("dc0-lv1", "dc-lv1"):
        dc = rng.integers(1, 256, nblk) * sign(nblk) if pattern == "dc-lv1" else 0 * dc
        zz[:, 1] = rng.integers(1, 60, nblk) * sign(nblk)
        for k in (4, 9, 20, 40, 63):
            zz[:, k] = rng.integers(1, 200, nblk) * sign(nblk) * (rng.random(nblk) < 0.7)
    elif pattern == "pair-across-lanes":
        j = rng.integers(1, 16, (nblk, 1))
        step = rng.integers(2, 6, (nblk, 1))
        k = np.arange(64)
        after = (k >= 4 * j + 2) & ((k - 4 * j - 2) % step == 0)
        before = (k >= 2) & (k < 4 * j - 2) & ((k - 2) % 3 == 0)  # never two in a row
        vals = rng.integers(1, 130, (nblk, 64)) * rng.choice([-1, 1], (nblk, 64))
        on = after | before | (k == 4 * j - 1) | (k == 4 * j)
        zz[on] = vals[on]
    elif pattern == "last-only":
        mags = np.array([1, 2, 40, 127, 128, 200, 255])
        zz[:, 63] = mags[rng.integers(0, len(mags), nblk)] * sign(nblk)
    else:
        raise ValueError(pattern)
    zz[:, 0] = dc
    return torch.from_numpy(zz).reshape(frames, 6, 9, 6, 64)


LEVEL_PATTERNS = ("dc0-lv1", "dc-lv1", "pair-across-lanes", "last-only", "sparse")


@pytest.mark.parametrize("frames", [1, 30])
@pytest.mark.parametrize("pattern", LEVEL_PATTERNS)
def test_compat_lanes_on_made_levels(pattern, frames):
    zz = _made_levels(pattern, frames, len(pattern) * 31 + frames)
    luts = Luts.compat("cpu")
    want, zl, code0, len0 = _twin_emission(zz, luts)
    codes, lens = cuda_vlc_compat.stream_slots(zz, luts)
    if pattern == "dc-lv1":  # slot 1 on: dropped, so only the EOB is left in slot 63
        assert (lens[..., 1:63] == 0).all() and (lens[..., 63] == 2).all()
    if pattern == "dc0-lv1":
        assert (lens[..., 1] > 0).all()
    if pattern == "last-only":
        assert set(lens[..., 63].unique().tolist()) == {22, 30}  # escapes + EOB
    _check(model_fused4(zl, code0, len0, luts), want)


# the case each mutation must fail on
MUTATION_CASES = {
    "dc-always-nonzero": "dc0-lv1",
    "pair-within-lane": "pair-across-lanes",
    "no-drop-from-below": "dc-lv1",
    "no-eob-when-dropped": "dc-lv1",
}


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutated_models_fail(mutation):
    pattern = MUTATION_CASES[mutation]
    zz = _made_levels(pattern, 1, len(pattern) * 31 + 1)
    luts = Luts.compat("cpu")
    want, zl, code0, len0 = _twin_emission(zz, luts)
    got = model_fused4(zl, code0, len0, luts, mutation=mutation)
    assert not all(torch.equal(to_i32_bits(g), w) for g, w in zip(got, want))
