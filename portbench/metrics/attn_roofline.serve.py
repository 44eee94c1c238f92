"""attn_roofline.serve: the fused attention's eval calls, the sum of their
bounds (counts.attn_bound_s from each call's shape) over the sum of the
device time they launched, in %."""

from benchlib.counts import attn_bound_s
from benchlib.rooflines import share


def read(ctx):
    if ctx.kind != "serve":
        return None
    return share(ctx.trace, {"pb:attn.eval": lambda s: attn_bound_s(
        "eval", s[0], s[1], s[2], bool(s[3]))})
