"""The least device time of `encode` with `bit_rate`: the RGB frames read
once (3 B a pixel) and the stream written once (the budget's zero bytes
included: they are bytes of the call's output); the encode's operations
(`correct_mode_ops` at quality 50: the AAN DCT, B1's emission, B2's pack)
and the count's.

The count: every slice's bits at each of the 31 scales, so per 8 x 8 block
and scale its 64 coefficients each quantized and their code lengths
summed.  Per coefficient and scale at least C_COUNT = 8 integer
operations: the quantization is an add (16 |F| + q W), a multiply-high
by the divisor's reciprocal and a clamp at 255 (3); the zero test and the
run carried to the next coefficient (2); the length looked up by (run,
|level|), an index add and a load (2); the bits summed (1).  The DCT it
shares with B1 is counted once here.  The count kernel alone
(`COUNT_OPS_BLOCK`; `COUNT_SHARE`, read by
`layer_metrics/bit_count_roofline_pct.py`) repeats the DCT (1,280 operations a block with its quantization, as
`PERF.md`'s kernel table counts the DCT kernels).

The colour and subsampling add no term (as `work/encode.py`).  At any
frame size the integer term bounds the call: ~18,500 operations a block
against 3.2 B a pixel."""

from __future__ import annotations

from portbench.work import OPS_DCT_BLOCK, OPS_EMIT_BLOCK, OPS_PACK_BLOCK, least_seconds, mb_blocks

SCALES = 31
C_COUNT = 8  # integer operations per coefficient and scale
OPS_COUNT_SCALES_BLOCK = SCALES * 64 * C_COUNT
OPS_CALL_BLOCK = OPS_DCT_BLOCK + OPS_EMIT_BLOCK + OPS_PACK_BLOCK + OPS_COUNT_SCALES_BLOCK
COUNT_OPS_BLOCK = 1280 + OPS_COUNT_SCALES_BLOCK  # the count kernel's own work
# the count kernel's least time as a share of a call's: both are bound by
# their integer operations, counted per block
COUNT_SHARE = COUNT_OPS_BLOCK / OPS_CALL_BLOCK


def least(config: dict, mix: dict, calls: int, stream_bytes: int) -> tuple[float, str]:
    h, w = config["height"], config["width"]
    frames = calls * config["frames_per_call"]
    return least_seconds(frames * h * w * 3 + stream_bytes,
                         frames * mb_blocks(h, w) * OPS_CALL_BLOCK)
