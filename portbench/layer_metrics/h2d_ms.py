"""Host-to-device copy time on the card per call (the entry's input
planes or coefficients, and its small tables)."""


def read(trace, ctx):
    us = trace.copies_us("HtoD")
    if not trace.calls or not us:
        return None
    return us / 1e3 / trace.calls
