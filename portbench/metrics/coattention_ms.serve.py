"""coattention_ms.serve: device ms per served batch launched inside the
co-attention's ranges (the co-attention of every pair: MHA in the VOC and
large-scale recipes, non-local in COCO's)."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    got = ctx.trace.ranges_named("pb:coattention")
    total = sum(s for _, s in got)
    if total <= 0.0:
        return None
    return 1e3 * total / ctx.steps
