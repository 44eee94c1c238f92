"""host_syncs.serve: the synchronizing CUDA calls a served batch makes (the
program's `host_syncs` count: each blocking copy, `.item()` or `nonzero`
that torch reports in its "warn" sync debug mode), over window 4."""


def read(ctx):
    rec = getattr(ctx, "recorded", None)
    if ctx.kind != "serve" or rec is None:
        return None
    return rec.syncs_a_step()
