"""The count kernel's least time over its device time: the kernels
launched inside the `bit_count_launch` spans, the port's lost records
scaled in (`tracefile.Trace.port_kernels`).  Its least time is the call's
(`ctx["least_s"]`, `work/encode_cbr.py`) times the count's share of the
call's integer operations: both are bound by those, at any frame size
(the kernel's bytes, the planes read once and 124 B a slice written, take
~2% of its operation bound)."""

from portbench.work import encode_cbr

SPAN = "bit_count_launch"


def read(trace, ctx):
    acc = trace.port_kernels().get(SPAN)
    if not acc or not acc["recorded"] or ctx.get("least_s") is None:
        return None
    device_us = acc["us"] * acc["launches"] / acc["recorded"]
    return 100.0 * ctx["least_s"] * encode_cbr.COUNT_SHARE / (device_us / 1e6)
