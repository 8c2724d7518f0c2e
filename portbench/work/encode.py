from __future__ import annotations

from portbench.work import correct_mode_ops, least_seconds, mb_blocks


def least(config: dict, mix: dict, calls: int, stream_bytes: int) -> tuple[float, str]:
    """The RGB frames read once (3 B a pixel), the stream written once; the
    encode's operations.  The colour and subsampling add no term of their
    own: their input is the RGB read, and their ~32 integer operations a
    pixel are not counted, so the least time is a floor."""
    h, w = config["height"], config["width"]
    frames = calls * config["frames_per_call"]
    int_ops, flops = correct_mode_ops(frames * mb_blocks(h, w), mix["quality"])
    return least_seconds(frames * h * w * 3 + stream_bytes, int_ops, flops)
