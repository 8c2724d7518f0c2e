"""Device time per call of the work launched inside the span `encode.rate`
(the rate control: the count kernel `bit_count_launch` and the plain-torch
choice of each picture's quantizer_scale)."""

from portbench.spans import per_call_ms, span_device_us


def read(trace, ctx):
    return per_call_ms(trace, span_device_us(trace, "encode.rate"))
