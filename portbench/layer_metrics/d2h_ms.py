"""Device-to-host copy time on the card per call: the bit counts and the
bucketed prefix of the slice buffers."""


def read(trace, ctx):
    us = trace.copies_us("DtoH")
    if not trace.calls or not us:
        return None
    return us / 1e3 / trace.calls
