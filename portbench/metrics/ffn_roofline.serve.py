"""ffn_roofline.serve: the fused FFN's calls, the sum of their bounds
(counts.ffn_bound_s from each call's rows) over the sum of the device time
they launched, in %."""

from benchlib.counts import ffn_bound_s
from benchlib.rooflines import share


def read(ctx):
    if ctx.kind != "serve":
        return None
    return share(ctx.trace, {"pb:ffn.fwd": lambda s: ffn_bound_s("fwd",
                                                                 s[0])})
