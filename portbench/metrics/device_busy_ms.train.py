"""device_busy_ms.train: device milliseconds a train step: the union of
kernel, copy and set intervals in the first traced window (the device
alone recorded) over its steps.  The host's noise, which moves the cell's
rate by several per cent from run to run, leaves it steady."""


def read(ctx):
    if ctx.kind != "train" or ctx.busy_s <= 0.0:
        return None
    return 1e3 * ctx.busy_s / ctx.steps
