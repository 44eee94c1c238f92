"""mfu.serve: the model's operations per served batch (counts.model_flops,
from the cell's shapes) times the batches of a window, over that window's
length run unprofiled (by the host clock, synchronized at both ends), as a
share of the H100's bf16 dense peak."""

from benchlib.counts import PEAK_BF16_FLOP_S


def read(ctx):
    if ctx.kind != "serve":
        return None
    return (100.0 * ctx.flops_per_step * ctx.steps / ctx.plain_window_s /
            PEAK_BF16_FLOP_S)
