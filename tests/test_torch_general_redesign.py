"""csrc/sh_attention_general.cu's split plan and fixed-order sums, on the
CPU.

The tiled attention kernels split the long side of each (head, pair) across
blocks (`fused_attention.general_plan`) and sum across blocks in a fixed
order: the split softmax's (m, l, o) partials, the gate's row-sum partials,
core_bwd_kv's split over query tiles, and the LayerNorm and dgate partials
of 16-row items.  `ops/attention_general.py` emulates that decomposition;
here it is held against the port's plain versions (f32 round-off: forward
1e-5 absolute, the per-pair backward 5e-6 of max |plain|) and, at narrow
widths (4 heads x 32, d_model 128) and the shape classes of
tests/test_torch_general_kernels.py, against the JAX package's Pallas
kernels in interpret mode with the JAX tests' own tolerances (forward 2e-5
absolute, 1e-5 relative; cotangents 2e-3 absolute, 1e-3 relative).  With a
stand-in library, the wrappers' launches pass the plan and its scratch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu.ops import pallas_attention as jpa
from ait_tpu_torch.ops import _build
from ait_tpu_torch.ops import attention_general as ag
from ait_tpu_torch.ops import fused_attention as pfa

H, DK, D, P = 4, 32, 128, 2
Plan = pfa.GeneralPlan
NAMES = ["dxq", "dxkv", "dwq", "dwk", "dwv", "dsk_w", "dsk_b", "dfc_w",
         "dln_s", "dln_b"]
PAIR_NAMES = ["dy", "o", "s", "dlogit", "ln partials", "dz", "dk", "dv",
              "dy0"]


def T(a):
    return torch.from_numpy(np.array(a))


def inputs(seed, tq, tk, kind, p=P):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    args = [arr(p, tq, D), arr(p, tk, D), arr(D, H * DK, scale=D ** -0.5),
            arr(D, H * DK, scale=D ** -0.5), arr(D, H * DK, scale=D ** -0.5),
            arr(DK, H * DK, scale=DK ** -0.5), arr(H * DK, scale=0.05),
            arr(DK, D, scale=DK ** -0.5),
            (1 + 0.1 * rng.randn(D)).astype(np.float32),
            (0.1 * rng.randn(D)).astype(np.float32)]
    if kind == "causal":
        mask = np.tril(np.ones((tq, tk), bool))
    elif kind == "pad":
        mask = np.broadcast_to(np.arange(tk) < tk - 9, (tq, tk)).copy()
    else:
        mask = np.ones((tq, tk), bool)
    keep = dict(attn_keep=(rng.rand(H, p * tq, tk) < 0.9).astype(np.float32),
                out_keep=(rng.rand(p * tq, D) < 0.9).astype(np.float32))
    return args, mask, arr(p, tq, D), keep


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("p,tq,tk,want", [
    (8, 1900, 64, Plan(1, 1, 4, 8, 264)),    # co-attention q2i
    (8, 64, 1900, Plan(4, 8, 1, 1, 32)),     # co-attention i2q
    (64, 128, 128, Plan(1, 2, 1, 2, 264)),
    (64, 96, 128, Plan(1, 2, 1, 2, 264))])
def test_plan_at_the_main_path_shapes(p, tq, tk, want):
    """On an H100 (132 SMs): the co-attention's one-tile side leaves 64
    blocks a grid, so its 30 tiles of the long side go 8 to a split, 256
    blocks, one wave at 2 an SM (5 splits of 6 would need two); the 65-128
    token shapes fill the card unsplit."""
    assert pfa.general_plan(p, tq, tk, 132) == want


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("p,tq,tk", [(1, 64, 1900), (8, 1900, 64),
                                     (3, 130, 65), (2, 1, 7), (8, 64, 1950),
                                     (1, 1900, 100)])
def test_plan_takes_every_tile_once(p, tq, tk, sms):
    plan = pfa.general_plan(p, tq, tk, sms)
    for n, splits, chunk in ((tk, plan.ksplits, plan.kchunk),
                             (tq, plan.qsplits, plan.qchunk)):
        tiles = [t for s in range(splits) for t in ag._tiles(n, chunk, s)]
        assert all(ag._tiles(n, chunk, s) for s in range(splits))
        assert tiles == [(a, min(n, a + 64)) for a in range(0, n, 64)]
    assert 1 <= plan.out_blocks <= min(2 * sms, p * -(-tq // 16))


# ---------------------------------------------- the emulation, plainly


def _projected(args, mask):
    x_q, x_kv, wq, wk, wv = args[:5]
    return pfa.project(x_q, x_kv, wq, wk, wv)


PLANS = [(150, 64, "full", Plan(1, 1, 2, 2, 4)),
         (150, 64, "full", Plan(1, 1, 3, 1, 4)),
         (64, 150, "full", Plan(2, 2, 1, 1, 4)),
         (64, 150, "pad", Plan(3, 1, 1, 1, 4)),
         (100, 48, "full", Plan(1, 1, 1, 2, 4)),
         (96, 128, "causal", Plan(2, 1, 2, 1, 4)),
         (128, 72, "pad", Plan(2, 1, 1, 2, 4))]


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("tq,tk,kind,plan", PLANS)
def test_forward_decomposition_matches_plain(tq, tk, kind, plan, dropout):
    """The split softmax (one pass, running max, splits combined in
    order) and the gate from row-sum partials: `sh_attention_core_reference`
    to f32 round-off (1e-5 absolute)."""
    args, mask, _, keep = inputs(0, tq, tk, kind)
    t = [T(a) for a in args]
    drop = dict(keep_prob=0.9, **{k: T(v) for k, v in keep.items()}) \
        if dropout else {}
    q, k, v = _projected(t, mask)
    rest = (t[5], t[6], t[7], t[0], t[8], t[9], T(mask), H, DK, DK)
    want = pfa.sh_attention_core_reference(q, k, v, *rest, return_oh=True,
                                           **drop)
    got = ag.general_core_reference(q, k, v, *rest[:7], plan, H, DK, DK,
                                    return_oh=True, **drop)
    for name, a, b in zip(("out", "oh"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("tq,tk,kind,plan", PLANS)
def test_backward_decomposition_matches_plain(tq, tk, kind, plan, dropout):
    """dz through the key splits (running max, combined in order), dk and
    dv through the query splits, the LayerNorm and dgate partials per
    16-row item: `sh_attention_bwd_pairs_reference` within 5e-6 of each
    output's max |plain| (the LayerNorm partials compared as their per-pair
    sums)."""
    args, mask, g, keep = inputs(1, tq, tk, kind)
    t = [T(a) for a in args]
    drop = dict(keep_prob=0.9, **{k: T(v) for k, v in keep.items()}) \
        if dropout else {}
    q, k, v = _projected(t, mask)
    oh = pfa.sh_attention_core_reference(
        q, k, v, t[5], t[6], t[7], t[0], t[8], t[9], T(mask), H, DK, DK,
        return_oh=True, **drop)[1]
    pair_args = (q, k, v, t[5], t[6], t[7], t[0], t[8], T(mask), oh, T(g))
    want = pfa.sh_attention_bwd_pairs_reference(*pair_args, H, DK, DK,
                                                **drop)
    got = ag.general_bwd_pairs_reference(*pair_args, plan, H, DK, DK, **drop)
    items = -(-tq // 16)
    assert tuple(got[4].shape) == (2, P * items, D)
    for name, a, b in zip(PAIR_NAMES, got, want):
        if name == "ln partials":
            a = a.reshape(2, P, items, D).sum(2)
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= 5e-6, (name, err)


def test_gate_row_sums_rebuild_the_forward_gate_bit_for_bit():
    """The backward rebuilds s from the saved o_h with the forward's own
    partials and order, so the two gates are the same bits; both within
    f32 round-off of the plain mean."""
    args, mask, _, _ = inputs(2, 150, 64, "full")
    t = [T(a) for a in args]
    q, k, v = _projected(t, mask)
    plan = Plan(1, 1, 1, 3, 4)
    _, oh = ag.general_core_reference(q, k, v, t[5], t[6], t[7], t[0], t[8],
                                      t[9], T(mask), plan, H, DK, DK,
                                      return_oh=True)
    ohh = oh.reshape(H, P, 150, DK).transpose(0, 1)
    fwd = ag.gate_mean(ag.gate_row_sums(ohh), 150)
    again = ag.gate_mean(ag.gate_row_sums(ohh.clone()), 150)
    assert torch.equal(fwd, again)
    plain = ohh.sum(1).mean(1)
    np.testing.assert_allclose(fwd.numpy(), plain.numpy(), rtol=0, atol=1e-6)
    sums = ag.gate_row_sums(ohh)
    assert tuple(sums.shape) == (P, 3, H, DK)
    np.testing.assert_allclose(sums[:, 2].numpy(),
                               ohh[:, :, 128:].sum(2).numpy(), atol=1e-5)


@pytest.mark.parametrize("qsplits,qchunk", [(1, 3), (2, 2), (3, 1)])
def test_bwd_kv_query_splits_agree(qsplits, qchunk):
    """dk and dv summed over 1, 2 or 3 query splits (the q2i shape class):
    the same values to f32 round-off (1e-6 of max |dk|, |dv|)."""
    args, mask, g, _ = inputs(3, 150, 64, "full")
    t = [T(a) for a in args]
    q, k, v = _projected(t, mask)
    oh = pfa.sh_attention_core_reference(
        q, k, v, t[5], t[6], t[7], t[0], t[8], t[9], T(mask), H, DK, DK,
        return_oh=True)[1]
    pair_args = (q, k, v, t[5], t[6], t[7], t[0], t[8], T(mask), oh, T(g))
    base = ag.general_bwd_pairs_reference(*pair_args, Plan(1, 1, 1, 3, 4),
                                          H, DK, DK)
    got = ag.general_bwd_pairs_reference(
        *pair_args, Plan(1, 1, qsplits, qchunk, 4), H, DK, DK)
    for i in (6, 7):
        err = (got[i] - base[i]).abs().max() / base[i].abs().max()
        assert err <= 1e-6, (PAIR_NAMES[i], err.item())


# ------------------------------------------ the emulation against Pallas

PALLAS = [(150, 64, "full", 1, Plan(1, 1, 3, 1, 4)),
          (64, 150, "full", 1, Plan(3, 1, 1, 1, 4)),
          (96, 128, "causal", 2, Plan(2, 1, 2, 1, 4))]


def _decomposed(args, mask, plan):
    """The port's kernel route with the general kernels' decomposition:
    `project`, then the emulated forward."""
    q, k, v = _projected(args, mask)
    return ag.general_core_reference(q, k, v, args[5], args[6], args[7],
                                     args[0], args[8], args[9], mask, plan,
                                     H, DK, DK, return_oh=True)


@pytest.mark.parametrize("tq,tk,kind,tile,plan", PALLAS)
def test_decomposed_forward_matches_pallas(tq, tk, kind, tile, plan):
    args, mask, _, _ = inputs(4, tq, tk, kind)
    want_out, want_oh = jpa._fused_call(
        *[jnp.asarray(a) for a in args], jnp.asarray(mask), n_head=H, d_k=DK,
        d_v=DK, dist="softmax", keep_prob=1.0, pair_tile=tile,
        interpret=True, save_oh=True)
    out, oh = _decomposed([T(a) for a in args], T(mask), plan)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(
        oh.numpy(), np.asarray(want_oh).reshape(H, P * tq, DK), rtol=0,
        atol=2e-5)


@pytest.mark.parametrize("tq,tk,kind,tile,plan", PALLAS)
def test_decomposed_backward_matches_pallas_vjp(tq, tk, kind, tile, plan):
    """The emulated per-pair part, then `bwd_products` (the products on
    csrc/gemm.cu, plain here): the Pallas VJP's ten cotangents."""
    args, mask, g, _ = inputs(5, tq, tk, kind)
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda *a: jpa.fused_sh_attention(
        *a, jnp.asarray(mask), H, DK, DK, "softmax", tile, True), *jargs)
    want = vjp(jnp.asarray(g))
    t = [T(a) for a in args]
    _, oh = _decomposed(t, T(mask), plan)
    q, k, v = _projected(t, T(mask))
    pairs = ag.general_bwd_pairs_reference(q, k, v, t[5], t[6], t[7], t[0],
                                           t[8], T(mask), oh, T(g), plan, H,
                                           DK, DK)
    got = pfa.bwd_products(t[0], t[1], t[2], t[3], t[4], pairs)
    for name, gv, wv in zip(NAMES, got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-3,
                                   atol=2e-3, err_msg=name)


# ---------------------------------------- launches, with a stand-in library


class FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_kernels(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda stem, funcs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(pfa, "device_sms", lambda device: 132)
    return lib


def _full_width(p, tq, tk):
    rng = np.random.RandomState(6)
    args = [rng.randn(p, tq, 512), rng.randn(p, tk, 512)] + [
        rng.randn(512, 512) * 0.04 for _ in range(3)] + [
        rng.randn(64, 512) * 0.1, rng.randn(512) * 0.05,
        rng.randn(64, 512) * 0.1]
    t = [T(a.astype(np.float32)) for a in args]
    t += [torch.ones(512), torch.zeros(512), torch.ones(tq, tk, dtype=bool)]
    return t


@pytest.mark.parametrize("p,tq,tk", [(2, 64, 1900), (2, 1900, 64)])
def test_forward_launch_passes_the_plan(p, tq, tk, fake_kernels):
    lib = fake_kernels
    t = _full_width(p, tq, tk)
    out, _ = pfa._forward(t[0], tuple(t), p, tq, tk, "general")
    (name, a), = lib.calls
    assert name == "sh_attention_general_fwd"
    assert len(a) == len(pfa._GENERAL_FUNCS[name])
    plan = pfa.general_plan(p, tq, tk, 132)
    assert a[21:27] == (p, tq, tk, plan.ksplits, plan.kchunk, plan.out_blocks)
    assert a[18] is not None                         # the row-sum partials
    assert (a[19] is not None) == (plan.ksplits > 1)
    assert (a[20] is not None) == (plan.ksplits > 1)
    assert out.shape == t[0].shape


@pytest.mark.parametrize("p,tq,tk", [(2, 64, 1900), (2, 1900, 64)])
def test_backward_launch_passes_the_plan(p, tq, tk, fake_kernels,
                                         monkeypatch):
    lib = fake_kernels
    t = _full_width(p, tq, tk)
    seen = []
    monkeypatch.setattr(pfa, "bwd_products",
                        lambda *a: seen.append(a[-1]) or (None,) * 10)
    oh = torch.zeros(8, p * tq, 64)
    g = torch.zeros(p, tq, 512)
    pfa._backward(t[0], tuple(t), oh, g, p, tq, tk, "general")
    (name, a), = lib.calls
    assert name == "sh_attention_general_bwd"
    assert len(a) == len(pfa._GENERAL_FUNCS[name])
    plan = pfa.general_plan(p, tq, tk, 132)
    assert a[32:40] == (p, tq, tk) + tuple(plan)
    assert (a[29] is not None) == (plan.ksplits > 1)
    assert (a[31] is not None) == (plan.qsplits > 1)
    dy, o, s, dgl, lnp, dz, dk, dv, dy0 = seen[0]
    items = -(-tq // 16)
    assert tuple(lnp.shape) == (2, p * items, 512)
    assert dy0 is dy and tuple(dk.shape) == (p * tk, 512)
