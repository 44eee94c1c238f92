"""device_wait_ms.serve: the ms a served batch waits in its `ait:d2h` span
(the two `.cpu()` reads of the detections, which wait for the device to
finish the batch), the mean over window 4 (the program's recorder on,
unprofiled)."""

from benchlib.recorded import under_ns


def read(ctx):
    rec = getattr(ctx, "recorded", None)
    if ctx.kind != "serve" or rec is None:
        return None
    return rec.mean_ms(lambda r, root: under_ns(r, root, "ait:d2h"))
