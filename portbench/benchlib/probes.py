"""The benchmark's own probes on the program: profiler ranges around the
calls into each layer, and the capture of what the timed path produced for
the correctness check.

A probe replaces a module attribute that the program looks up at call time
(or a submodule's `forward`) with a wrapper that calls the original; `undo`
puts every original back.  Range names start with "pb:"; a kernel wrapper's
range carries its call's shape after a "|", from which the roofline readers
compute the call's bound.
"""

from __future__ import annotations

import functools
import importlib
from typing import Callable, List, Tuple

import torch


class Probes:
    def __init__(self):
        self._undo: List[Tuple[object, str, object, bool]] = []

    def wrap(self, owner, attr: str, make: Callable):
        """owner.attr = make(original)."""
        had = attr in vars(owner)
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, vars(owner).get(attr), had))
        setattr(owner, attr, make(orig))

    def undo(self):
        for owner, attr, orig, had in reversed(self._undo):
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()


def ranged(name: str, shape_of: Callable = None):
    """A wrapper maker that runs the call inside record_function(name)."""
    def make(orig):
        @functools.wraps(orig)
        def wrapper(*args, **kw):
            label = name if shape_of is None else (
                f"{name}|{shape_of(*args, **kw)}")
            with torch.profiler.record_function(label):
                return orig(*args, **kw)
        return wrapper
    return make


def _attn_shape(x_q, x_kv, *rest, **kw):
    p, tq, _ = x_q.shape
    return f"{p},{tq},{x_kv.shape[1]},{int(x_kv is x_q)}"


def _rows(x, *rest, **kw):
    return str(x.shape[0])


def install_ranges(probes: Probes, model) -> None:
    """Ranges around the detector's stages (for the per-layer readers and
    to label the device's idle gaps) and around the fused attention's and
    FFN's wrappers, forward and backward."""
    det = importlib.import_module("ait_tpu_torch.models.detector")
    fa = importlib.import_module("ait_tpu_torch.ops.fused_attention")
    ff = importlib.import_module("ait_tpu_torch.ops.fused_ffn")
    for sub, label in (("backbone", "pb:backbone"),
                       ("coattention", "pb:coattention"),
                       ("rpn", "pb:rpn_head"),
                       ("transformer", "pb:transformer"),
                       ("sk", "pb:sknet"), ("top", "pb:top")):
        mod = getattr(model, sub)
        probes.wrap(mod, "forward", ranged(label))
    probes.wrap(det, "proposal_layer", ranged("pb:proposals"))
    probes.wrap(det, "roi_align", ranged("pb:roi_align"))
    probes.wrap(det, "anchor_targets", ranged("pb:targets"))
    probes.wrap(det, "proposal_targets", ranged("pb:targets"))
    probes.wrap(fa, "fused_sh_attention", ranged("pb:attn.eval", _attn_shape))
    probes.wrap(fa, "fused_sh_attention_saved",
                ranged("pb:attn.saved", _attn_shape))
    probes.wrap(fa, "fused_sh_attention_bwd",
                ranged("pb:attn.bwd", _attn_shape))
    probes.wrap(ff, "fused_ffn", ranged("pb:ffn.fwd", _rows))
    probes.wrap(ff, "fused_ffn_bwd", ranged("pb:ffn.bwd", _rows))
    probes.wrap(ff, "posln", ranged("pb:glue"))


class Capture:
    """Keeps the proposal layer's inputs and output, and the head's outputs,
    of the calls made while `on` is set."""

    def __init__(self):
        self.on = False
        self.records: List[dict] = []

    def install(self, probes: Probes):
        det = importlib.import_module("ait_tpu_torch.models.detector")
        pred = importlib.import_module("ait_tpu_torch.predict")

        def proposal(orig):
            @functools.wraps(orig)
            def wrapper(rpn_out, anchors, im_info, **kw):
                rois = orig(rpn_out, anchors, im_info, **kw)
                if self.on:
                    self.records.append({
                        "rpn_cls": rpn_out.cls_logits.detach(),
                        "rpn_deltas": rpn_out.bbox_deltas.detach(),
                        "rois": rois.detach()})
                return rois
            return wrapper

        def post(orig):
            @functools.wraps(orig)
            def wrapper(rois, cls_prob, bbox_pred, im_info, **kw):
                if self.on:
                    self.records[-1].update(cls_prob=cls_prob.detach(),
                                            bbox_pred=bbox_pred.detach())
                return orig(rois, cls_prob, bbox_pred, im_info, **kw)
            return wrapper

        probes.wrap(det, "proposal_layer", proposal)
        probes.wrap(pred, "postprocess_detections", post)
