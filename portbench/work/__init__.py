"""The least device time of one call of each entry, by entry name.

Each module names the work of its entry point from the cell's shapes and
the call's stream bytes alone, whatever kernels carry it: the bytes that
must move (each input byte read once, each stream byte written once) over
the memory's peak, and the operations that each 8 x 8 block needs over the
integer (and f32) peaks.  The least time is the largest of these terms."""

from __future__ import annotations

from portbench import peaks

# Integer operations per 8 x 8 block, as `chip_smoke.py` counts them: the
# AAN DCT (16 butterflies of 36 adds and multiplies, 64 descaling
# shifts), quantization (6 per coefficient), the emission (4 per slot),
# and the pack (30 per fused slot, 16 fused slots a block).
OPS_DCT_BLOCK = 16 * 36 + 64 + 64 * 6
OPS_QUANT_BLOCK = 64 * 6
OPS_EMIT_BLOCK = 64 * 4
OPS_PACK_BLOCK = 16 * 30
# the f32 matrix DCT: two 8 x 8 x 8 products, a multiply and an add each
FLOPS_F32_DCT_BLOCK = 2 * 8 * 8 * 8 * 2
# the islow IDCT: 16 one-dimensional passes of 36 multiplies and adds,
# and per pixel a descaling add, a shift and a clamp in each pass
OPS_IDCT_BLOCK = 16 * 36 + 64 * 6


def least_seconds(nbytes: float, int_ops: float, f32_flops: float = 0.0) -> tuple[float, str]:
    """(least seconds, which term bounds it)."""
    terms = {"bytes": nbytes / peaks.MEM_BYTES_PER_S, "int_ops": int_ops / peaks.INT_OPS_PER_S,
             "f32": f32_flops / peaks.F32_FLOPS_PER_S}
    which = max(terms, key=terms.get)
    return terms[which], which


def mb_blocks(height: int, width: int) -> int:
    """8 x 8 blocks of a macroblock-padded 4:2:0 frame."""
    return -(-height // 16) * -(-width // 16) * 6


def correct_mode_ops(blocks: int, quality: int) -> tuple[float, float]:
    """(integer ops, f32 flops) of the correct-mode encode of `blocks`:
    the integer AAN DCT below quality 70, the f32 DCT at 70 and above (the
    encoder's dct_impl="auto")."""
    tail = OPS_QUANT_BLOCK + OPS_EMIT_BLOCK + OPS_PACK_BLOCK
    if quality >= 70:
        return blocks * tail, blocks * FLOPS_F32_DCT_BLOCK
    return blocks * (OPS_DCT_BLOCK + OPS_EMIT_BLOCK + OPS_PACK_BLOCK), 0.0
