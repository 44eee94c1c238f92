"""attn_roofline.train: the fused attention's train forward (saved
per-head outputs) and backward calls, the sum of their bounds over the sum
of the device time they launched, in %."""

from benchlib.counts import attn_bound_s
from benchlib.rooflines import share


def read(ctx):
    if ctx.kind != "train":
        return None
    return share(ctx.trace, {
        "pb:attn.saved": lambda s: attn_bound_s("saved", s[0], s[1], s[2],
                                                bool(s[3])),
        "pb:attn.bwd": lambda s: attn_bound_s("bwd", s[0], s[1], s[2],
                                              bool(s[3]))})
