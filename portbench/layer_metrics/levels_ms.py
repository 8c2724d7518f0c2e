"""Device time per call of the work launched inside the span
`encode.levels` (`plane_levels`: blockize, the f32 `matmul_dct`, quantize,
zigzag and DC prediction in plain torch on the card)."""

from portbench.spans import per_call_ms, span_device_us


def read(trace, ctx):
    return per_call_ms(trace, span_device_us(trace, "encode.levels"))
