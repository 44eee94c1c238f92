"""The port's Adam and global-norm clipping against ait_tpu's optax chain
(`make_optimizer(..., optimizer="adam", clip_norm=c)`), on the tiny
flagship's full param tree (weight, bias and frozen leaves), CPU float32.

Three steps on numpy-seeded gradients.  The frozen leaves get zero
gradients, as the JAX model gives them (its stem kernel and FrozenBN arrays
sit behind stop_gradient; tests/test_torch_accum_step.py checks that on a
real step), so optax's norm over the whole tree is the norm over the
trainable leaves that the port computes.  Every parameter delta must agree
within 1e-4 of its leaf's max |optax delta| (the same operations per
element, with torch's fused loops free to contract a multiply-add and the
norm summed in another order) plus 4 ulps of the leaf's largest value: a
delta is read as new - old, and a LayerNorm scale near 1 holds its ~2e-3
delta only to the 1.2e-7 spacing of float32 at 1.  Up to 1e-6 of the tree's
elements may miss that and must stay within 1e-2 of the max delta: where a
clipped gradient cancels against the weight-decay term (g ~ -wd * p, a few
of the tree's 4e7 elements), Adam's first step lr * g / (|g| + eps) turns
one ulp of the clipped gradient into up to lr / eps = 1e5 times as much
(measured: 3.9e-7 on a delta of 3.9e-5, from 4e-12 in the gradient), and
the two frameworks round g / norm * max_norm apart by that ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_harness as harness
from ait_tpu.train import lr_schedule as jlr_schedule
from ait_tpu.train import make_optimizer as jmake_optimizer
from ait_tpu.train.optim import param_label as jparam_label
from ait_tpu_torch import bridge
from ait_tpu_torch.models import AITDetector
from ait_tpu_torch.train import (clip_by_global_norm_, lr_schedule,
                                 make_optimizer, set_lr)
from test_torch_train_optim import get, leaves

STEPS = 3
REL = 1e-4
ILL_CONDITIONED = 1e-6        # share of the tree's elements, see above


def nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def seeded_grads(params, scale):
    rng = np.random.RandomState(3)
    return [{path: (np.zeros(np.shape(v), np.float32)
                    if jparam_label(path) == "frozen" else
                    (scale * rng.randn(*np.shape(v))).astype(np.float32))
             for path, v in leaves(params)} for _ in range(STEPS)]


def global_norm(flat):
    return float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in flat.values())))


# (optimizer, clip_norm relative to the first step's gradient norm): no clip;
# a clip far above the norm (never triggers); a clip at half the norm
# (triggers every step); SGD with a triggering clip
CASES = [("adam", None), ("adam", 4.0), ("adam", 0.5), ("sgd", 0.5)]


@pytest.mark.parametrize("optimizer,clip_rel", CASES)
def test_three_steps_match_optax(optimizer, clip_rel):
    cfg, _, params, pcfg, _ = harness.flagship()
    grads = seeded_grads(params, 1e-3)
    norms = [global_norm(g) for g in grads]
    clip = None if clip_rel is None else clip_rel * norms[0]
    if clip is not None:
        assert all((n > clip) == (clip_rel < 1) for n in norms), norms

    sched = jlr_schedule(1e-3, 2, 1, 0.1)          # decays after step 1
    tx = jmake_optimizer(cfg, sched, optimizer=optimizer, clip_norm=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    update = jax.jit(tx.update)
    for g in grads:
        upd, st = update(jax.tree_util.tree_map(jnp.asarray, nest(g)), st, jp)
        jp = optax.apply_updates(jp, upd)

    model = AITDetector(pcfg)
    model.load_state_dict(bridge.to_state_dict(model, params))
    opt = make_optimizer(pcfg, model, optimizer=optimizer, clip_norm=clip)
    assert isinstance(opt, torch.optim.Adam if optimizer == "adam"
                      else torch.optim.SGD)
    assert opt.clip_norm == clip
    psched = lr_schedule(1e-3, 2, 1, 0.1)
    trainable = [p for grp in opt.param_groups for p in grp["params"]]
    for step, g in enumerate(grads):
        sd = bridge.to_state_dict(model, nest(g))
        for k, p in model.named_parameters():
            p.grad = sd[k].clone() if p.requires_grad else None
        if opt.clip_norm:                    # what make_train_step does
            norm = clip_by_global_norm_((p.grad for p in trainable),
                                        opt.clip_norm)
            np.testing.assert_allclose(float(norm), norms[step], rtol=1e-5)
        set_lr(opt, psched(step))
        opt.step()
    new = bridge.to_jax_tree(model, model.state_dict())
    bad = []
    over = total = 0
    for path, old in leaves(params):
        old = np.asarray(old)
        want = get(jp, path) - old
        got = get(new, path) - old
        if jparam_label(path) == "frozen":
            assert not want.any() and not got.any(), path
            continue
        scale = float(np.abs(want).max())
        assert scale > 0, path
        err = np.abs(got - want)
        tol = REL * scale + 4 * float(np.spacing(np.abs(old).max()))
        over += int((err > tol).sum())
        total += err.size
        if err.max() > 1e-2 * scale:
            bad.append(("/".join(path), float(err.max()), scale))
    assert not bad, bad[:10]
    assert over <= ILL_CONDITIONED * total, (over, total)


def test_clip_divides_by_the_norm_itself_like_optax():
    """g / norm * max_norm where norm >= max_norm (no epsilon in the
    divisor), untouched where norm < max_norm; frozen zeros change
    nothing."""
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "frozen": np.zeros((4,), np.float32)}
    norm = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                             for v in tree.values())))
    for max_norm in (0.25 * norm, 2.0 * norm):
        tx = optax.clip_by_global_norm(max_norm)
        want, _ = tx.update({k: jnp.asarray(v) for k, v in tree.items()},
                            tx.init(tree))
        got = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
        out = clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(float(out), norm, rtol=1e-6)
        for k, g in zip(("a", "b"), got):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                       rtol=2e-7, atol=0)


def test_unknown_optimizer_is_refused():
    _, _, _, pcfg, _ = harness.flagship()
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(pcfg, AITDetector(pcfg), optimizer="adamw")
