"""The A14 detectors of the port against ait_tpu's, float32 on the CPU, one
numpy-seeded param tree on both sides through the weight bridge, the tiny
flagship's sizes (TEST tops 32 -> 8, TRAIN 64 -> 16, 8 rois an image, a
96x128 uint8 canvas) with one model path switched each:

* `coco`: the COCO flavour, `--dataset coco`'s overrides (the non-local
  co-attention, 'division', anchor scales (4, 8, 16, 32));
* `softmax`: the same with coatt_normalization 'softmax';
* `vgg16`: cfgs/vgg16.yml's model (VGG16 backbone and top, channels 512;
  fc6 flattens the transformer's 8x8 query grid: 32,768 x 4,096);
* `pool`: POOLING_MODE 'pool';
* `contextual`: the contextual relation (bidirectional GRU) and `lstm`
  (two-layer unidirectional LSTM).

Eval forward: rois within 1e-2 px, cls_prob within 1e-5, bbox_pred within
1e-4 (tests/test_torch_a20.py's tolerances: box decode's exp differs from
XLA's in the last ulp).  One train step (`make_train_step` on both sides,
SGD, model.t_dropout 0) for `coco` and `vgg16` (at 64x64 queries and
3x3 rois: fc6 8,192 x 4,096; the eval test's is 32,768 x 4,096), the sampling uniforms
injected through `AnchorDraws` / `ProposalDraws` and VGGTop's four 0.5
masks through `jax.random.bernoulli` and `Dropout(masks=)`: every loss
within 1e-4 relative, every parameter's step within 5e-3 of its leaf's max
|JAX step| (measured up to 2.8e-3, the COCO flavour's encoder FFN, against
1e-5 in its eval forward: the train path's sampled rois come from
decoded boxes, which differ in the last ulp), 2e-2 in the backbone and top
(f32 ReLUs within rounding of 0 can take the other branch in one
framework, tests/test_torch_train_step.py),
or within 1e-8 absolute (a step of lr 1e-3 times a 1e-5 gradient: where a
leaf's gradient cancels, as the bias of a conv before the non-local
co-attention's GroupNorm does, its step is f32 roundoff, measured 3.7e-9),
and the frozen leaves (VGG16's conv1_*/conv2_*, every BN) unchanged.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
import __graft_entry__ as graft
from ait_tpu.models import detector as jdet
from ait_tpu.models.detector import AITDetector as JaxDetector
from ait_tpu.train import TrainState
from ait_tpu.train import lr_schedule as jlr_schedule
from ait_tpu.train import make_optimizer as jmake_optimizer
from ait_tpu.train.state import make_train_step as jmake_train_step
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.models import detector as pdet
from ait_tpu_torch.models.dropout import Dropout
from ait_tpu_torch.train import lr_schedule, make_optimizer, make_train_step

B = 2
KEY_A, KEY_P = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
LOSS_REL, STEP_REL, DEEP_REL, STEP_ABS = 1e-4, 5e-3, 2e-2, 1e-8

PATHS = {
    "coco": dict(model={"coattention": "nonlocal"},
                 top={"ANCHOR_SCALES": (4, 8, 16, 32)}),
    "softmax": dict(model={"coattention": "nonlocal",
                           "coatt_normalization": "softmax"}),
    "vgg16": dict(model={"backbone": "vgg16", "channels": 512}),
    "pool": dict(top={"POOLING_MODE": "pool"}),
    "contextual": dict(model={"with_contextual_relation": True}),
    "lstm": dict(model={"with_contextual_relation": True,
                        "rnn_method": "LSTM", "rnn_layers": 2,
                        "rnn_bidirectional": False}),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def _config(path, t_dropout=None):
    cfg, _ = graft._flagship(tiny=True)
    spec = PATHS[path]
    model = dict(spec.get("model", {}))
    top = dict(spec.get("top", {}))
    train = {}
    if t_dropout is not None:
        model["t_dropout"] = t_dropout
        if path == "vgg16":
            # the train step's VGG16 flattens a 4x4 query grid (64x64
            # queries, 3x3 rois so the encoder's 9 tokens fit the query's
            # 16): fc6 8,192 x 4,096, a quarter of the eval test's
            train["query_size"] = 64
            top["POOLING_SIZE"] = 3
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model),
        TRAIN=dataclasses.replace(cfg.TRAIN, **train), **top)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    q = cfg.TRAIN.query_size
    image = rng.randint(0, 256, (B, harness.H, harness.W, 3)).astype(np.uint8)
    query = rng.randint(0, 256, (B, q, q, 3)).astype(np.uint8)
    info = np.tile(np.asarray([[harness.H - 8, harness.W - 16, 1.0]],
                              np.float32), (B, 1))
    gt = np.zeros((B, cfg.MAX_NUM_GT_BOXES, 5), np.float32)
    gt[:, 0] = [8, 8, 60, 60, 1]
    gt[1, 1] = [30, 20, 100, 80, 1]
    return {"image": image, "query": query, "im_info": info,
            "gt_boxes": gt, "num_boxes": np.ones((B,), np.int32)}


def _models(cfg, seed=0):
    jm = JaxDetector(cfg, dtype=jnp.float32)
    g = _batch(cfg)
    shapes = harness.jax_shapes(jm, *(jnp.asarray(g[k]) for k in (
        "image", "query", "im_info", "gt_boxes", "num_boxes")), train=False)
    params = bridge.random_tree(shapes, seed)
    pm = AITDetector(harness.port_config(cfg), dtype=torch.float32)
    assert bridge.jax_shapes(pm) == shapes
    pm.load_state_dict(bridge.to_state_dict(pm, params))
    return jm, pm, params


@pytest.mark.parametrize("path", sorted(PATHS))
def test_eval_forward_matches_jax(path):
    cfg = _config(path)
    jm, pm, params = _models(cfg)
    b = _batch(cfg)
    jout = jax.jit(lambda p, i, q, ii, g, n: jm.apply(
        {"params": p}, i, q, ii, g, n, train=False))(
            params, *(jnp.asarray(b[k]) for k in (
                "image", "query", "im_info", "gt_boxes", "num_boxes")))
    pm.eval()
    with torch.inference_mode():
        pout = pm(T(b["image"]), T(b["query"]), T(b["im_info"]))
    for name, atol in (("rois", 1e-2), ("cls_prob", 1e-5),
                       ("bbox_pred", 1e-4)):
        want = np.asarray(getattr(jout, name))
        got = getattr(pout, name).numpy()
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)
    if path == "vgg16":
        assert pm.cls_score_0.weight.shape == (8, 2 * 4096)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("path", ["coco", "vgg16"])
def test_train_step_matches_jax(path):
    cfg = _config(path, t_dropout=0.0)
    jm, pm, params = _models(cfg, seed=1)
    batch = _batch(cfg, seed=2)
    t = cfg.TRAIN
    h, w = (-(-n // 16) for n in (harness.H, harness.W))
    n_anchors = h * w * len(cfg.ANCHOR_SCALES) * len(cfg.ANCHOR_RATIOS)
    adraws = harness.anchor_draws(KEY_A, B, n_anchors)
    pdraws = harness.proposal_draws(
        KEY_P, B, t.RPN_POST_NMS_TOP_N + cfg.MAX_NUM_GT_BOXES, t.BATCH_SIZE)
    r = B * t.BATCH_SIZE
    # VGGTop's dropouts at 0.5: fc6 and fc7 on the rois, then on the query
    masks = (harness.keep_masks([(r, 4096)] * 2 + [(B, 4096)] * 2, 0.5,
                                seed=3) if path == "vgg16" else [])
    sched = (t.LEARNING_RATE, 100, 5, t.GAMMA)

    mp = pytest.MonkeyPatch()
    real_at, real_pt = jdet.anchor_targets, jdet.proposal_targets
    mp.setattr(jdet, "anchor_targets",
               lambda a, g, i, key, **kw: real_at(a, g, i, KEY_A, **kw))
    mp.setattr(jdet, "proposal_targets",
               lambda r_, g, key, **kw: real_pt(r_, g, KEY_P, **kw))
    feed = harness.BernoulliFeed(masks or None)
    mp.setattr(jax.random, "bernoulli", feed)
    try:
        tx = jmake_optimizer(cfg, jlr_schedule(*sched))
        state = TrainState.create(params, tx)
        state, jmet = jax.jit(jmake_train_step(jm, tx))(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
    finally:
        mp.undo()
    assert feed.i == len(masks)

    with pytest.MonkeyPatch.context() as mp2:
        mp2.setattr(pdet, "anchor_targets",
                    functools.partial(pdet.anchor_targets, draws=adraws))
        mp2.setattr(pdet, "proposal_targets",
                    functools.partial(pdet.proposal_targets, draws=pdraws))
        mp2.setattr(pdet, "Dropout", lambda rate, generator=None: Dropout(
            rate, generator, masks=masks))
        pcfg = harness.port_config(cfg)
        step = make_train_step(pm, make_optimizer(pcfg, pm),
                               lr_schedule(*sched), device="cpu")
        pmet = step({k: T(v) for k, v in batch.items()}, torch.Generator())
        new = bridge.to_jax_tree(pm, pm.state_dict())

    for name in ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "margin",
                 "rcnn_box"):
        want, got = float(jmet[name]), float(pmet[name])
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_REL * max(abs(want), 1e-6), name
    for name in ("fg_cnt", "bg_cnt"):
        assert int(jmet[name]) == int(pmet[name]), name
    moved = 0
    for leaf, before in _leaves(params):
        jstep = np.asarray(_get(state.params, leaf)) - before
        pstep = _get(new, leaf) - before
        if not np.abs(jstep).max():
            np.testing.assert_array_equal(pstep, 0, err_msg="/".join(leaf))
            continue
        moved += 1
        rel = DEEP_REL if leaf[0] in ("backbone", "top") else STEP_REL
        assert np.abs(pstep - jstep).max() <= max(
            rel * np.abs(jstep).max(), STEP_ABS), "/".join(leaf)
    assert moved > 100
    if path == "vgg16":
        for conv in ("conv1_1", "conv1_2", "conv2_1", "conv2_2"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    _get(new, ("backbone", conv, leaf)),
                    _get(params, ("backbone", conv, leaf)))


def test_short_query_grid_raises_as_jax():
    """A query grid with fewer tokens than a roi's (64x64 queries, 7x7
    rois): ait_tpu's encoder pad fails, and so does the port's instead of
    cropping the roi's tokens."""
    from ait_tpu.models.ait_transformer import AITTransformer as JaxT
    from ait_tpu_torch.models.ait_transformer import AITTransformer

    kw = dict(d_model=16, d_inner=32, n_head=2, d_k=8, d_v=8, channels=32)
    props, query = np.zeros((2, 7, 7, 32), np.float32), np.zeros(
        (1, 4, 4, 32), np.float32)
    with pytest.raises(ValueError):
        harness.jax_shapes(JaxT(d_word_vec=16, dtype=jnp.float32, **kw),
                           jnp.asarray(props), jnp.asarray(query))
    with pytest.raises(ValueError, match="fewer than a roi's"):
        AITTransformer(**kw)(T(props), T(query))
