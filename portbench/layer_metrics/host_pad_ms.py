"""Host time per call in the encoder's validation and macroblock edge
padding of the planes or frames (the span `encode.pad`)."""

from portbench.spans import per_call_ms, span_us


def read(trace, ctx):
    return per_call_ms(trace, span_us(trace, "encode.pad"))
