"""Host time per call in assembling the stream from the fetched slices
(the span `encode.assemble`: correct mode's `assemble`; compat's system
stream and `.bit` dumps)."""

from portbench.spans import per_call_ms, span_us


def read(trace, ctx):
    return per_call_ms(trace, span_us(trace, "encode.assemble"))
