"""host_step_ms.train: the host's ms a train step, the mean `ait:train_step`
span of window 4 (the program's recorder on, unprofiled); the step returns
before the device finishes it, so against device_busy_ms.train it says
whether the host issues a step faster than the card runs it."""


def read(ctx):
    rec = getattr(ctx, "recorded", None)
    if ctx.kind != "train" or rec is None:
        return None
    return rec.mean_ms(lambda r, root: root.dur_ns)
