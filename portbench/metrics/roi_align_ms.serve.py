"""roi_align_ms.serve: device ms per served batch launched inside ROI
Align's range."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    got = ctx.trace.ranges_named("pb:roi_align")
    total = sum(s for _, s in got)
    if total <= 0.0:
        return None
    return 1e3 * total / ctx.steps
