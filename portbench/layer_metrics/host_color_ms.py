"""Host time per call in compat mode's f64 colour conversion (the span
`encode.color`, `rgb_to_ycbcr_exact`)."""

from portbench.spans import per_call_ms, span_us


def read(trace, ctx):
    return per_call_ms(trace, span_us(trace, "encode.color"))
