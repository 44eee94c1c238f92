"""device_idle_share.serve: the share of a window of served batches in which no
kernel, copy or set runs on the device: one minus the union of their
intervals in the first profiled window (the device alone recorded) over
the length of as many steps run unprofiled (by the host clock,
synchronized at both ends), since the profiler slows the host."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    if ctx.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.plain_window_s)
