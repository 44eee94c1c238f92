"""backward_idle_ms.train: the device's idle ms a train step while the host
is inside `ait:backward` (the `.backward()` call): window 5 (CUDA activity
profiled, the program's recorder on), each idle interval split among the
innermost program spans open over it."""


def read(ctx):
    rec = getattr(ctx, "recorded", None)
    if ctx.kind != "train" or rec is None:
        return None
    return rec.idle_ms_inside(lambda name: name == "ait:backward")
