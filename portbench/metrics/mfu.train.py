"""mfu.train: the operations of one train step (the forward and what
autograd runs backward, counts.model_flops) times the steps of a window,
over that window's length run unprofiled (by the host clock, synchronized
at both ends), as a share of the H100's bf16 dense peak."""

from benchlib.counts import PEAK_BF16_FLOP_S


def read(ctx):
    if ctx.kind != "train":
        return None
    return (100.0 * ctx.flops_per_step * ctx.steps / ctx.plain_window_s /
            PEAK_BF16_FLOP_S)
