"""Device time per call of the work launched inside the span
`encode.rgb420` (the RGB intake: studio-range BT.601 colour and 4:2:0
subsampling in plain torch int32 on the card)."""

from portbench.spans import per_call_ms, span_device_us


def read(trace, ctx):
    return per_call_ms(trace, span_device_us(trace, "encode.rgb420"))
