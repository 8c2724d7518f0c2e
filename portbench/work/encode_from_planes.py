from __future__ import annotations

from portbench.work import correct_mode_ops, least_seconds, mb_blocks


def least(config: dict, mix: dict, calls: int, stream_bytes: int) -> tuple[float, str]:
    """The planes read once (Y and two quarter-size chroma planes), the
    stream written once; the encode's operations."""
    h, w = config["height"], config["width"]
    frames = calls * config["frames_per_call"]
    plane_bytes = h * w + 2 * -(-h // 2) * -(-w // 2)
    int_ops, flops = correct_mode_ops(frames * mb_blocks(h, w), mix["quality"])
    return least_seconds(frames * plane_bytes + stream_bytes, int_ops, flops)
