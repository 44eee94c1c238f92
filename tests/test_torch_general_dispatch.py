"""Where `MultiHeadAttention` sends a shape, in the port and in ait_tpu, with
the long-sequence switch off (the default) and on; and the rule that a tensor
off the CPU reaches a kernel or raises in the new regimes too.

JAX's side is traced only (`jax.eval_shape` of the module's init): the fused
branch is the one that calls `jax.lax.platform_dependent`.  The port's side
runs one pair on the CPU with `fused_attention.sh_attention` spied on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ait_tpu.models import attention as jattn
from ait_tpu_torch.models import attention as pattn
from ait_tpu_torch.models.coattention import MHACoAttention
from ait_tpu_torch.ops import fused_attention as pfa

D, H, DK = 512, 8, 64
# (Tq, Tk): inside both limits; the co-attention's classes; one token past the
# short bound on one side; both sides past it; area just inside (128 x 1536 =
# 192 K) and just outside the long regime's limit
SHAPES = [(128, 128), (64, 64), (300, 64), (64, 300), (129, 64), (129, 129),
          (128, 1536), (128, 1537)]


def jax_fuses(lq, lk, long_seq, monkeypatch):
    calls = []
    real = jax.lax.platform_dependent
    monkeypatch.setattr(jattn, "_LONG_SEQ_FUSION", long_seq)
    monkeypatch.setattr(jax.lax, "platform_dependent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = jattn.MultiHeadAttention(H, D, DK, DK, dropout=0.0)
    q = jnp.zeros((1, lq, D), jnp.float32)
    k = jnp.zeros((1, lk, D), jnp.float32)
    jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), q, k, k))
    return bool(calls)


def port_fuses(lq, lk, long_seq, monkeypatch, **kw):
    calls = []
    real = pfa.sh_attention
    monkeypatch.setattr(pattn, "_LONG_SEQ_FUSION", long_seq)
    monkeypatch.setattr(pfa, "sh_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = pattn.MultiHeadAttention(H, D, DK, DK)
    g = torch.Generator().manual_seed(0)
    for p in m.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.03
    q = torch.randn(1, lq, D, generator=g)
    k = torch.randn(1, lk, D, generator=g)
    v = kw.pop("v", k)
    with torch.no_grad():
        out = m(q, k, k if v is None else v, **kw)
    assert out.shape == q.shape and torch.isfinite(out).all()
    return bool(calls)


def test_switches_default_off_as_in_jax():
    assert pattn._LONG_SEQ_FUSION is False and jattn._LONG_SEQ_FUSION is False
    assert pfa._SAVE_QKV is False
    from ait_tpu.ops import pallas_attention as jpa
    assert jpa._SAVE_QKV is False


@pytest.mark.parametrize("long_seq", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("lq,lk", SHAPES)
def test_shape_goes_where_jax_sends_it(lq, lk, long_seq, monkeypatch):
    want = jax_fuses(lq, lk, long_seq, monkeypatch)
    got = port_fuses(lq, lk, long_seq, monkeypatch)
    assert got == want, (lq, lk, long_seq)
    short = lq <= 128 and lk <= 128
    long_ok = long_seq and min(lq, lk) <= 128 and lq * lk <= 192 * 1024
    assert got == (short or long_ok)


def test_fused_path_stops_at_128_and_starts_at_65(monkeypatch):
    """65-128 tokens now take the fused path, as in JAX (they took the plain
    path while the port's only kernel stopped at 64)."""
    assert port_fuses(65, 64, False, monkeypatch)
    assert port_fuses(128, 100, False, monkeypatch)
    assert not port_fuses(129, 64, False, monkeypatch)


def test_per_example_mask_and_separate_values_take_the_plain_path(monkeypatch):
    mask = torch.ones(2, 8, 8, dtype=torch.bool)
    calls = []
    real = pfa.sh_attention
    monkeypatch.setattr(pfa, "sh_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = pattn.MultiHeadAttention(H, D, DK, DK)
    x = torch.randn(2, 8, D)
    with torch.no_grad():
        m(x, x, x, mask=mask)              # batch-variant mask
        m(x, x, x.clone())                 # k is not v
        assert not calls
        m(x, x, x, mask=mask[:1])
    assert calls == [1]


@pytest.mark.parametrize("long_seq", [False, True], ids=["off", "on"])
def test_coattention_path_follows_the_switch(long_seq, monkeypatch):
    """130 image tokens (a 10 x 13 map) against 64 query tokens: both
    attentions plain by default, both fused under the switch, same result."""
    calls = []
    real = pfa.sh_attention
    monkeypatch.setattr(pattn, "_LONG_SEQ_FUSION", long_seq)
    monkeypatch.setattr(pfa, "sh_attention", lambda *a, **k: calls.append(
        (a[0].shape[1], a[1].shape[1])) or real(*a, **k))
    co = MHACoAttention(1024, H, DK, DK)
    g = torch.Generator().manual_seed(1)
    for p in co.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.03
    img = torch.randn(1, 10, 13, 1024, generator=g)
    qry = torch.randn(1, 8, 8, 1024, generator=g)
    with torch.no_grad():
        a, b = co(img, qry)
        monkeypatch.setattr(pattn, "_LONG_SEQ_FUSION", False)
        n = len(calls)
        a0, b0 = co(img, qry)
    assert calls[:n] == ([(130, 64), (64, 130)] if long_seq else [])
    np.testing.assert_allclose(a.numpy(), a0.numpy(), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(b.numpy(), b0.numpy(), rtol=1e-5, atol=2e-5)


def test_kernel_regimes():
    assert pfa.kernel_regime(56, 56) == pfa.kernel_regime(64, 64) == "short"
    for tq, tk in [(65, 64), (128, 128), (1900, 64), (64, 1900), (128, 1536)]:
        assert pfa.kernel_regime(tq, tk) == "general", (tq, tk)
    for tq, tk in [(129, 129), (128, 1537), (0, 8), (3000, 128)]:
        assert pfa.kernel_regime(tq, tk) is None, (tq, tk)


def _operands(device, tq, tk, p=2):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(device)

    return [r(p, tq, D), r(p, tk, D), r(D, D), r(D, D), r(D, D),
            r(DK, H * DK), r(H * DK), r(DK, D), r(D), r(D),
            torch.ones(tq, tk, dtype=torch.bool, device=device)]


WRAPPERS = {"eval": ("fused_sh_attention", "sh_attention_reference"),
            "saved": ("fused_sh_attention_saved",
                      "sh_attention_saved_reference"),
            "bwd": ("fused_sh_attention_bwd", "sh_attention_bwd_reference")}
COUNTS = ("launches", "general_launches", "dropout_launches",
          "general_dropout_launches", "qkv_launches")


def _call(kind, ops, tq, p=2):
    fn = getattr(pfa, WRAPPERS[kind][0])
    if kind != "bwd":
        return fn(*ops)
    oh = torch.zeros(H, p * tq, DK, device=ops[0].device)
    return fn(*ops, oh, torch.zeros_like(ops[0]))


@pytest.mark.parametrize("tq,tk", [(150, 64), (64, 150), (100, 80)])
@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_general_regime_kernel_or_raise(kind, tq, tk, monkeypatch):
    """A CPU tensor of a general-regime shape takes the plain version and
    counts no launch; a tensor off the CPU (meta: no GPU here) never takes
    the plain version: it raises before any launch."""
    wrapper, plain = WRAPPERS[kind]
    fn = getattr(pfa, wrapper)
    before = {c: getattr(fn, c, None) for c in COUNTS}
    calls = []
    real = getattr(pfa, plain)
    monkeypatch.setattr(pfa, plain,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _call(kind, _operands("cpu", tq, tk), tq)
    assert calls == [1]
    monkeypatch.setattr(pfa, plain, lambda *a, **k: pytest.fail(
        "the plain version ran for a tensor off the CPU"))
    with pytest.raises(ValueError, match="CUDA"):
        _call(kind, _operands("meta", tq, tk), tq)
    assert {c: getattr(fn, c, None) for c in COUNTS} == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk", [(150, 64), (64, 150), (100, 80)])
def test_general_kernels_match_plain_versions_on_gpu(tq, tk, cuda,
                                                     monkeypatch):
    """float32, TF32 off: forward within 2e-3 absolute, every cotangent
    within 5e-3 of its max |plain|; the launches count in the general
    regime's counters only."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ops = _operands(cuda, tq, tk)
    ops[2:8] = [w * 0.04 for w in ops[2:8]]
    before = (pfa.fused_sh_attention_saved.general_launches,
              pfa.fused_sh_attention_saved.launches)
    out, oh = pfa.fused_sh_attention_saved(*ops)
    want_out, want_oh = pfa.sh_attention_saved_reference(*ops)
    assert (pfa.fused_sh_attention_saved.general_launches,
            pfa.fused_sh_attention_saved.launches) == (before[0] + 1,
                                                       before[1])
    assert (out - want_out).abs().max().item() <= 2e-3
    assert (oh - want_oh).abs().max().item() <= 2e-3
    g = torch.randn_like(out)
    got = pfa.fused_sh_attention_bwd(*ops, oh, g)
    want = pfa.sh_attention_bwd_reference(*ops, oh, g)
    for i, (a, b) in enumerate(zip(got, want)):
        assert ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)
                ).item() <= 5e-3, i


@pytest.mark.gpu
def test_kernel_refuses_unfusable_shape_on_gpu(cuda):
    with pytest.raises(ValueError, match="sequences"):
        pfa.fused_sh_attention(*_operands(cuda, 129, 129))
    with pytest.raises(ValueError, match="saved only"):
        pfa.fused_sh_attention_saved(*_operands(cuda, 150, 64),
                                     save_qkv=True)
