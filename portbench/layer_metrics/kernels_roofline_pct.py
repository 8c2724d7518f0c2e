"""The least device time of the traced calls' work (`work/`: bytes over
the memory's peak or operations over the integer and f32 peaks) as a share
of the summed device time of every kernel in the window (copies and sets
not counted), with the port's lost kernel records scaled in."""


def read(trace, ctx):
    kernel_us, _, _ = trace.kernel_us()
    if not kernel_us or ctx.get("least_s") is None:
        return None
    return 100.0 * ctx["least_s"] / (kernel_us / 1e6)
