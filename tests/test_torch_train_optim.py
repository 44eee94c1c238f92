"""The port's optimizer, schedule, param labels and reverse weight bridge
against ait_tpu's, on the tiny flagship's full param tree, CPU float32.

Two SGD steps on seeded random gradients must give optax's parameters
within 1e-6 of each leaf's max |value| (the same operations in the same
order per element; torch's fused loop may contract a multiply-add, one
rounding).  Labels and schedules are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.train import lr_schedule as jlr_schedule
from ait_tpu.train import make_optimizer as jmake_optimizer
from ait_tpu.train.optim import param_label as jparam_label
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.train import (lr_schedule, make_optimizer, param_label,
                                 set_lr)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_param_label_on_every_flagship_leaf():
    _, _, params, _, _ = harness.flagship()
    labels = {}
    for path, _ in leaves(params):
        labels[path] = param_label(path)
        assert labels[path] == jparam_label(path), path
    assert set(labels.values()) == {"frozen", "bias", "weight"}
    # the stem conv and every FrozenBN array are frozen
    assert labels[("backbone", "conv1", "kernel")] == "frozen"
    assert labels[("backbone", "layer1", "block0", "bn1", "scale")] == \
        "frozen"


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    want = jlr_schedule(0.01, 7, 2, 0.1, warmup_steps=warmup)
    got = lr_schedule(0.01, 7, 2, 0.1, warmup_steps=warmup)
    for step in range(0, 40):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


def test_optimizer_groups_follow_the_labels():
    cfg, _, params, pcfg, _ = harness.flagship()
    model = AITDetector(pcfg)
    opt = make_optimizer(pcfg, model)
    weights, biases = (set(map(id, g["params"])) for g in opt.param_groups)
    t = pcfg.TRAIN
    assert opt.param_groups[0]["weight_decay"] == t.WEIGHT_DECAY
    assert opt.param_groups[1]["lr_mult"] == 1 + int(t.DOUBLE_BIAS)
    named = dict(model.named_parameters())
    for key, path, _, _ in bridge.mappings(model):
        label = jparam_label(path)
        if key not in named:
            assert label == "frozen", path          # FrozenBN buffers
            continue
        p = named[key]
        assert (id(p) in weights) == (label == "weight"), path
        assert (id(p) in biases) == (label == "bias"), path
        assert p.requires_grad == (label != "frozen"), path


def test_two_sgd_steps_match_optax():
    cfg, _, params, pcfg, _ = harness.flagship()
    rng = np.random.RandomState(0)
    grads = [{path: rng.randn(*np.shape(v)).astype(np.float32)
              for path, v in leaves(params)} for _ in range(2)]

    def nest(flat):
        out = {}
        for path, v in flat.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
        return out

    sched = jlr_schedule(0.02, 1, 1, 0.1)          # decays after step 0
    tx = jmake_optimizer(cfg, sched)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, nest(g)), st,
                            jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)

    model = AITDetector(pcfg)
    model.load_state_dict(bridge.to_state_dict(model, params))
    opt = make_optimizer(pcfg, model)
    psched = lr_schedule(0.02, 1, 1, 0.1)
    for step, g in enumerate(grads):
        gtree = nest(g)
        sd = bridge.to_state_dict(model, gtree)
        for k, p in model.named_parameters():
            p.grad = sd[k] if p.requires_grad else None
        set_lr(opt, psched(step))
        opt.step()
    new = bridge.to_jax_tree(model, model.state_dict())
    for path, old in leaves(params):
        want = get(jp, path)
        got = get(new, path)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale,
                                   err_msg="/".join(path))
        if jparam_label(path) == "frozen":
            np.testing.assert_array_equal(got, np.asarray(old))


def test_reverse_bridge_round_trip_and_refusals():
    _, _, params, pcfg, model = harness.flagship()
    back = bridge.to_jax_tree(model, model.state_dict())
    for path, v in leaves(params):
        np.testing.assert_array_equal(get(back, path), np.asarray(v))
    sd = dict(model.state_dict())
    with pytest.raises(ValueError, match="left over"):
        bridge.to_jax_tree(model, dict(sd, extra=torch.zeros(1)))
    sd.pop("cls_score_0.weight")
    with pytest.raises(ValueError, match="missing"):
        bridge.to_jax_tree(model, sd)


def test_grad_tree_gives_zeros_for_frozen_and_buffers():
    _, _, params, pcfg, _ = harness.flagship()
    model = AITDetector(pcfg)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    tree = bridge.grad_tree(model)
    assert not get(tree, ("backbone", "conv1", "kernel")).any()
    assert not get(tree, ("backbone", "bn1", "mean")).any()
    assert get(tree, ("cls_score_0", "kernel")).all()
