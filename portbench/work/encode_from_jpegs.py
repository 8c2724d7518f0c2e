"""The least device time of `encode_from_jpegs`.  The JPEG decode is
host work (the native decoder's threads) and is not counted."""

from __future__ import annotations

from portbench.work import encode_from_planes


def least(config: dict, mix: dict, calls: int, stream_bytes: int) -> tuple[float, str]:
    """That of `encode_from_planes` on the decoded planes: the planes read
    once, the stream written once, the encode's operations."""
    return encode_from_planes.least(config, mix, calls, stream_bytes)
