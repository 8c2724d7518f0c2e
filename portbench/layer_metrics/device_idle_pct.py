"""The share of the traced window in which no kernel, copy or set ran on
the card.  Lost kernel records (see `tracefile`) can only raise it, by at
most the port's kernels' share of the window."""


def read(trace, ctx):
    if not trace.calls or not trace.device or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
