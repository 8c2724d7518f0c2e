"""Host time per call in the decode of the call's JPEGs (the span
`encode.jpeg_decode` of `encode_from_jpegs`: the native decoder's
threaded batch decode, entropy decode and IDCT, waited for on the
calling thread)."""

from portbench.spans import per_call_ms, span_us


def read(trace, ctx):
    return per_call_ms(trace, span_us(trace, "encode.jpeg_decode"))
