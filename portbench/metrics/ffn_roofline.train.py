"""ffn_roofline.train: the fused FFN's forward and backward calls, the sum
of their bounds over the sum of the device time they launched, in %."""

from benchlib.counts import ffn_bound_s
from benchlib.rooflines import share


def read(ctx):
    if ctx.kind != "train":
        return None
    return share(ctx.trace, {
        "pb:ffn.fwd": lambda s: ffn_bound_s("fwd", s[0]),
        "pb:ffn.bwd": lambda s: ffn_bound_s("bwd", s[0])})
