"""Device time per call of the work launched inside the span
`encode.intake` (the coefficients intake: the islow IDCT, the crop and
the edge padding in plain torch on the card)."""

from portbench.spans import per_call_ms, span_device_us


def read(trace, ctx):
    return per_call_ms(trace, span_device_us(trace, "encode.intake"))
