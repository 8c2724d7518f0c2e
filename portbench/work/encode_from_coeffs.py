from __future__ import annotations

from portbench.work import OPS_IDCT_BLOCK, correct_mode_ops, least_seconds, mb_blocks


def least(config: dict, mix: dict, calls: int, stream_bytes: int) -> tuple[float, str]:
    """The int16 coefficients read once (2 B a sample), the stream written
    once; the islow IDCT of every coefficient block and the encode."""
    h, w = config["height"], config["width"]
    ch, cw = -(-h // 2), -(-w // 2)
    frames = calls * config["frames_per_call"]
    coeff_blocks = -(-h // 8) * -(-w // 8) + 2 * -(-ch // 8) * -(-cw // 8)
    int_ops, flops = correct_mode_ops(frames * mb_blocks(h, w), mix["quality"])
    int_ops += frames * coeff_blocks * OPS_IDCT_BLOCK
    return least_seconds(frames * coeff_blocks * 64 * 2 + stream_bytes, int_ops, flops)
