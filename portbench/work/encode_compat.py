from __future__ import annotations

from portbench.work import OPS_DCT_BLOCK, OPS_EMIT_BLOCK, OPS_PACK_BLOCK, least_seconds

CROP_BLOCKS = 6 * 9 * 6  # 6 column bands of 9 macroblocks of 6 blocks


def least(config: dict, mix: dict, calls: int, stream_bytes: int) -> tuple[float, str]:
    """Compat mode codes a fixed 96 x 144 crop: its blocks' pixels read
    once, the stream written once; the encode's operations.  The `.bit`
    dumps and the colour conversion are host work."""
    frames = calls * config["frames_per_call"]
    blocks = frames * CROP_BLOCKS
    return least_seconds(blocks * 64 + stream_bytes,
                         blocks * (OPS_DCT_BLOCK + OPS_EMIT_BLOCK + OPS_PACK_BLOCK))
