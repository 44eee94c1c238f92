"""backbone_idle_ms.serve: the device's idle ms a served batch while the
host is inside the backbone's spans (`ait:backbone.image`,
`ait:backbone.query`): window 5 (CUDA activity profiled, the program's
recorder on), each idle interval split among the innermost program spans
open over it."""


def read(ctx):
    rec = getattr(ctx, "recorded", None)
    if ctx.kind != "serve" or rec is None:
        return None
    return rec.idle_ms_inside(lambda name: name.startswith("ait:backbone."))
