"""The port's sanitizer (`debug_checks`) against the reference's guards.

* B2's checked form (`pack_fused4(..., checks=True)`; on CPU tensors its
  twin) against `pack_words_fused4_core(debug=True, interpret=True)`, the
  pattern of tests/test_kernel_guards.py: healthy slots give 0 violations
  and unchanged bytes, a fused length of 200 gives the same count (exact),
  injected overlapping bits a count above 0 on both sides (the TPU counts
  byte-plane cells over 255, the port words or placements: the overlap
  term is compared as zero / nonzero).
* The encoder: a negated bit count raises (the reference's
  `_run_with_regrow`), and so does an injected slot violation or a bad
  fused length under `debug_checks`, in correct mode (both DCTs) and in
  compat mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ec504_imageencoder_tpu.ops.pallas_pack import _fuse2_32, _fuse2_64, pack_words_fused4_core
from ec504_imageencoder_tpu_torch.models import mpeg1
from ec504_imageencoder_tpu_torch.models.encoder import encode_compat
from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.ops import cuda_pack

MAX_WORDS = 640


def _fused_slots(seed):
    """(2, 512) fused slots from 2048 raw codes per slice (the reference's
    own 4:1 fusion), as numpy u32 / i32 arrays."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 25, (2, 2048)).astype(np.int32)
    codes = (rng.integers(0, 1 << 31, lens.shape) & ((1 << np.maximum(lens, 1)) - 1)).astype(np.uint32)
    cm = jnp.where(jnp.asarray(lens) > 0, jnp.asarray(codes), jnp.uint32(0))
    h1, l1, len1 = _fuse2_32(cm, jnp.asarray(lens), jnp)
    return [np.array(a) for a in _fuse2_64(h1, l1, len1, jnp)]


def _reference(slots):
    words, nbits, viol = pack_words_fused4_core(
        *slots, MAX_WORDS, bit_offset=38, emit_be=True, debug=True, interpret=True)
    return np.asarray(words).view(np.uint8).reshape(2, -1), np.asarray(nbits), np.asarray(viol)


def _port(slots):
    ins = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) for a in slots]
    return [t.numpy() for t in cuda_pack.pack_fused4(*ins, MAX_WORDS, bit_offset=38, checks=True)]


def _overlap(slots):
    """Slots 10..29 of slice 0: 16-bit lengths whose values carry 16 more
    one bits above them, onto the previous slot's bits."""
    for a in slots[:3]:
        a[0, 10:30] = 0
    slots[3][0, 10:30] = np.uint32(0xFFFFFFFF)
    slots[4][0, 10:30] = 16
    return slots


def _long(slots):
    slots[4][0, 7] = 200
    return slots


@pytest.mark.parametrize("fault", ["none", "length 200", "overlap"])
def test_checked_pack_matches_pallas_guards(fault):
    slots = _fused_slots(11)
    if fault == "length 200":
        slots = _long(slots)
    elif fault == "overlap":
        slots = _overlap(slots)
    seg, nbits, viol = _port(slots)
    want_seg, want_bits, want_viol = _reference(slots)
    assert viol.dtype == np.int32 and np.array_equal(nbits, want_bits)
    if fault == "none":
        assert viol.tolist() == want_viol.tolist() == [0, 0]
        assert np.array_equal(seg, want_seg)
        plain = cuda_pack.pack_fused4(
            *[torch.from_numpy(a.view(np.int32)) for a in slots], MAX_WORDS, bit_offset=38)
        assert np.array_equal(plain[0].numpy(), seg)
    elif fault == "length 200":
        assert viol.tolist() == want_viol.tolist() == [1, 0]
        assert np.array_equal(seg, want_seg)  # neither places the long slot
    else:
        assert viol[0] > 0 and want_viol[0] > 0
        assert viol[1] == want_viol[1] == 0


def test_checked_pack_counts_every_overlap():
    """Overlaps the TPU's byte-plane sums miss (contributions to one word
    from two window positions, or bytes whose sum stays <= 255) still
    count here."""
    slots = _fused_slots(11)
    for a in slots[:3]:
        a[0, 10:12] = 0
    slots[3][0, 10:12] = np.uint32(0xFFFFFFFF)
    slots[4][0, 10] = 32
    slots[4][0, 11] = 8  # 24 one bits above its length, onto slot 10's
    assert _reference(slots)[2].tolist() == [0, 0]
    assert _port(slots)[2].tolist() == [1, 0]


def test_negated_bit_count_raises():
    """F1: the port's `_run_with_regrow` raises on a negated bit count, as
    the reference's does, instead of assembling a truncated stream."""
    enc = TorchMPEG1IntraEncoder(quality=50, device="cpu")
    seg = torch.zeros((1, 2, 256), dtype=torch.uint8)
    bits = torch.tensor([[400, -3]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match=r"invariant violations in 1 slice\(s\) \(3 total hits\)"):
        enc._run_with_regrow(lambda msb: (seg, bits), 4)


def _frames():
    return np.random.default_rng(9).integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)


@pytest.mark.parametrize("fault", ["length 31", "code bit above its length", "dct guard"])
def test_injected_slot_violation_raises_aan(monkeypatch, fault):
    """A corrupted raw slot of B6a (monkeypatched into the encoder's
    raw-slot function) reaches the checks and raises."""
    real = mpeg1.vlc_raw

    def corrupt(*args):
        codes, lens, viol = real(*args)
        if fault == "length 31":
            lens[0, 5, 0] = 31
        elif fault == "code bit above its length":
            codes[1, 7, 3] |= 1 << int(lens[1, 7, 3])
        else:
            viol[2] += 1
        return codes, lens, viol

    monkeypatch.setattr(mpeg1, "vlc_raw", corrupt)
    enc = TorchMPEG1IntraEncoder(quality=50, debug_checks=True, device="cpu")
    with pytest.raises(RuntimeError, match="invariant violations"):
        enc.encode(_frames())
    # without debug_checks the raw-slot route does not run at all
    assert TorchMPEG1IntraEncoder(quality=50, device="cpu").encode(_frames())


def test_injected_slot_violation_raises_f32(monkeypatch):
    real = mpeg1.block_streams_lut

    def corrupt(*args):
        codes, lens = real(*args)
        lens[0, 3, 9] = 31
        return codes, lens

    monkeypatch.setattr(mpeg1, "block_streams_lut", corrupt)
    enc = TorchMPEG1IntraEncoder(quality=85, debug_checks=True, device="cpu")
    assert enc.dct_impl == "f32"
    with pytest.raises(RuntimeError, match="invariant violations"):
        enc.encode(_frames())


@pytest.mark.parametrize("mode", ["aan", "f32", "compat"])
def test_bad_fused_length_raises(monkeypatch, mode):
    """A fused length of 200 after healthy raw slots: only the checked pack
    sees it (F2: compat's debug_checks packed without B2's guards).  Every
    mode fuses its raw slots in `mpeg1.pack_checked`."""
    real = mpeg1.fuse4_i32

    def corrupt(codes, lens):
        v0, v1, v2, v3, flens = real(codes, lens)
        flens[0, 3] = 200
        return v0, v1, v2, v3, flens

    monkeypatch.setattr(mpeg1, "fuse4_i32", corrupt)
    with pytest.raises(RuntimeError, match="invariant violations"):
        if mode == "compat":
            encode_compat(np.zeros((1, 144, 96, 3), np.uint8), 12, device="cpu", debug_checks=True)
        else:
            TorchMPEG1IntraEncoder(quality=50, dct_impl=mode, debug_checks=True,
                                   device="cpu").encode(_frames())
