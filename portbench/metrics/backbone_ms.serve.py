"""backbone_ms.serve: device ms per served batch launched inside the
backbone's ranges (the image and the query pass together)."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    got = ctx.trace.ranges_named("pb:backbone")
    total = sum(s for _, s in got)
    if total <= 0.0:
        return None
    return 1e3 * total / ctx.steps
