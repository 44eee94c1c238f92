"""host_enqueue_ms.serve: the host's ms a served batch outside its wait for
the detections: the mean `ait:predict` span of window 4 (the program's
recorder on, unprofiled) less the `ait:d2h` span inside it (the two
`.cpu()` reads).  Against device_busy_ms.serve it says whether the host
issues a batch faster than the card runs it."""

from benchlib.recorded import under_ns


def read(ctx):
    rec = getattr(ctx, "recorded", None)
    if ctx.kind != "serve" or rec is None:
        return None
    return rec.mean_ms(
        lambda r, root: root.dur_ns - under_ns(r, root, "ait:d2h"))
