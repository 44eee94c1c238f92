"""The dropout forms of the port's kernel wrappers and the mask dump: a CPU
tensor takes the plain version, a tensor off the CPU goes to the kernel or
raises, and on the card each kernel matches its plain version fed the
dumped masks, the dump bit-equals the plain Philox stream, and a kernel
refuses what it does not take.

This file imports nothing of JAX, so on a machine with a GPU and no JAX the
card tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_dropout_dispatch.py
"""

import pytest
import torch

from ait_tpu_torch.ops import dropout_masks as pdm
from ait_tpu_torch.ops import fused_attention as pfa
from ait_tpu_torch.ops import fused_ffn as pff
from ait_tpu_torch.ops import philox

D, H, DK, HID = 512, 8, 64, 2048
KEEP = 0.9
P, TQ, TK, N, T = 3, 8, 8, 72, 8


def _operands(device, dtype=torch.float32):
    """Valid operands of each dropout wrapper at small shapes, with a seed."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=g) * scale).to(device, dt)

    attn = [r(P, TQ, D), r(P, TK, D), r(D, D, scale=D ** -0.5),
            r(D, D, scale=D ** -0.5), r(D, D, scale=D ** -0.5),
            r(DK, H * DK, scale=DK ** -0.5), r(H * DK, scale=0.05),
            r(DK, D, scale=DK ** -0.5), 1 + r(D, scale=0.1, dt=torch.float32),
            r(D, scale=0.1, dt=torch.float32),
            torch.tril(torch.ones(TQ, TK, dtype=torch.bool)).to(device)]
    ffn = [r(N, D), r(D, HID, scale=D ** -0.5),
           r(HID, scale=0.05, dt=torch.float32), r(HID, D, scale=HID ** -0.5),
           r(D, scale=0.05, dt=torch.float32),
           1 + r(D, scale=0.1, dt=torch.float32),
           r(D, scale=0.1, dt=torch.float32)]
    posln = [r(N, D), r(T, D), 1 + r(D, scale=0.1, dt=torch.float32),
             r(D, scale=0.1, dt=torch.float32)]
    seed = torch.tensor([123, -456], dtype=torch.int32, device=device)
    return dict(attn=attn, oh=r(H, P * TQ, DK, dt=torch.float32),
                g_attn=r(P, TQ, D), ffn=ffn, g_rows=r(N, D), posln=posln,
                seed=seed)


def _drop(ops, source):
    if source == "seed":
        return dict(keep_prob=KEEP, seed=ops["seed"])
    ak, ok = pdm.dropout_keep_masks(torch.tensor([5, 6], dtype=torch.int32),
                                    P, TQ, TK, D, keep_prob=KEEP)
    dev = ops["seed"].device
    return dict(keep_prob=KEEP, attn_keep=ak.to(dev), out_keep=ok.to(dev))


def _calls(ops):
    """kernel name -> a call of its wrapper with dropout on `ops`."""
    s = dict(keep_prob=KEEP, seed=ops["seed"])
    return {
        "attention_saved": lambda: pfa.fused_sh_attention_saved(
            *ops["attn"], **_drop(ops, "seed")),
        "attention_saved_operand_masks": lambda: pfa.fused_sh_attention_saved(
            *ops["attn"], **_drop(ops, "masks")),
        "attention_bwd": lambda: pfa.fused_sh_attention_bwd(
            *ops["attn"], ops["oh"], ops["g_attn"], **_drop(ops, "seed")),
        "attention_bwd_operand_masks": lambda: pfa.fused_sh_attention_bwd(
            *ops["attn"], ops["oh"], ops["g_attn"], **_drop(ops, "masks")),
        "ffn": lambda: (pff.fused_ffn(*ops["ffn"], **s),),
        "ffn_bwd": lambda: pff.fused_ffn_bwd(*ops["ffn"], ops["g_rows"], **s),
        "posln": lambda: (pff.fused_posln(*ops["posln"], **s),),
        "posln_bwd": lambda: pff.fused_posln_bwd(*ops["posln"],
                                                 ops["g_rows"], **s),
    }


WRAPPERS = {
    "attention_saved": (pfa, "fused_sh_attention_saved",
                        "sh_attention_saved_reference"),
    "attention_saved_operand_masks": (pfa, "fused_sh_attention_saved",
                                      "sh_attention_saved_reference"),
    "attention_bwd": (pfa, "fused_sh_attention_bwd",
                      "sh_attention_bwd_reference"),
    "attention_bwd_operand_masks": (pfa, "fused_sh_attention_bwd",
                                    "sh_attention_bwd_reference"),
    "ffn": (pff, "fused_ffn", "ffn_reference"),
    "ffn_bwd": (pff, "fused_ffn_bwd", "ffn_bwd_reference"),
    "posln": (pff, "fused_posln", "posln_reference"),
    "posln_bwd": (pff, "fused_posln_bwd", "posln_bwd_reference"),
}


def _counts(fn):
    return fn.launches, fn.dropout_launches


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_cpu_tensor_takes_plain_version(kernel, monkeypatch):
    mod, wrapper, plain = WRAPPERS[kernel]
    calls = []
    real = getattr(mod, plain)
    monkeypatch.setattr(mod, plain,
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    before = _counts(getattr(mod, wrapper))
    out = _calls(_operands("cpu"))[kernel]()
    assert len(calls) == 1 and calls[0]["keep_prob"] == KEEP
    assert all(t.device.type == "cpu" and torch.isfinite(t).all()
               for t in out)
    assert _counts(getattr(mod, wrapper)) == before


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_non_cpu_tensor_never_takes_plain_version(kernel, monkeypatch):
    """Meta tensors (no GPU here): the wrapper raises before any launch."""
    mod, wrapper, plain = WRAPPERS[kernel]
    monkeypatch.setattr(mod, plain, lambda *a, **k: pytest.fail(
        "the plain version ran for a tensor off the CPU"))
    before = _counts(getattr(mod, wrapper))
    with pytest.raises(ValueError, match="CUDA"):
        _calls(_operands("meta"))[kernel]()
    assert _counts(getattr(mod, wrapper)) == before


def test_mask_dump_cpu_is_the_philox_stream():
    seed = torch.tensor([7, 8], dtype=torch.int32)
    before = pdm.keep_mask.launches
    got = pdm.ffn_keep_mask(seed, 10, 12, keep_prob=KEEP)
    want = philox.keep_mask(seed, philox.TAG_FFN, 1, 10, 12, KEEP)[0]
    assert torch.equal(got, want)
    assert pdm.keep_mask.launches == before


def test_mask_dump_off_cpu_raises():
    seed = torch.tensor([7, 8], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pdm.keep_mask(seed, philox.TAG_ATTN, 2, 3, 16, KEEP)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_kernel_matches_plain_version_on_gpu(kernel, cuda, monkeypatch):
    """float32, TF32 off, the plain version fed the masks the kernel used
    (the dump kernel's for a seed): forward outputs within 2e-3 absolute,
    every cotangent within 5e-3 of its max |plain| (the gates of
    tools/tpu_kernel_check.py)."""
    mod, wrapper, plain = WRAPPERS[kernel]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ops = _operands(cuda)
    seed = ops["seed"]
    if kernel.startswith("attention"):
        drop = _drop(ops, "masks" if kernel.endswith("masks") else "seed")
        if kernel.startswith("attention_bwd"):   # the oh this forward saves
            ops["oh"] = pfa.fused_sh_attention_saved(*ops["attn"], **drop)[1]
        if "seed" in drop:
            ak, ok = pdm.dropout_keep_masks(seed, P, TQ, TK, D,
                                            keep_prob=KEEP)
            masks = dict(attn_keep=ak, out_keep=ok, keep_prob=KEEP)
        else:
            masks = drop
    else:
        dump = pdm.ffn_keep_mask if kernel.startswith("ffn") \
            else pdm.posln_keep_mask
        masks = dict(keep=dump(seed, N, D, keep_prob=KEEP), keep_prob=KEEP)
    before = _counts(getattr(mod, wrapper))
    got = _calls(ops)[kernel]()
    torch.cuda.synchronize()
    assert _counts(getattr(mod, wrapper)) == (before[0], before[1] + 1)
    args = {"attention_saved": ops["attn"],
            "attention_saved_operand_masks": ops["attn"],
            "attention_bwd": ops["attn"] + [ops["oh"], ops["g_attn"]],
            "attention_bwd_operand_masks": ops["attn"] + [ops["oh"],
                                                          ops["g_attn"]],
            "ffn": ops["ffn"], "ffn_bwd": ops["ffn"] + [ops["g_rows"]],
            "posln": ops["posln"],
            "posln_bwd": ops["posln"] + [ops["g_rows"]]}[kernel]
    want = getattr(mod, plain)(*args, **masks)
    if not isinstance(want, tuple):
        want = (want,)
    for i, (a, b) in enumerate(zip(got, want)):
        if "bwd" in kernel:
            assert _rel_err(a, b) <= 5e-3, i
        else:
            assert (a - b).abs().max().item() <= 2e-3, i


@pytest.mark.gpu
@pytest.mark.parametrize("tag", [1, 2, 3, 4])
def test_mask_dump_bit_equals_plain_on_gpu(tag, cuda):
    """The dump kernel against the plain Philox stream, bit for bit, at a
    block length that is not a multiple of 4 as well; two launches equal;
    keep rate within 0.01 of keep_prob."""
    seed = torch.tensor([-5, 99], dtype=torch.int32, device=cuda)
    for heads, blocks, length in ((H, 64, TQ * TK), (1, 1000, 510),
                                  (H, 3, 56 * 3 + 2)):
        got = pdm.keep_mask(seed, tag, heads, blocks, length, KEEP)
        again = pdm.keep_mask(seed, tag, heads, blocks, length, KEEP)
        want = philox.keep_mask(seed, tag, heads, blocks, length, KEEP)
        assert torch.equal(got, want) and torch.equal(got, again)
        assert abs(got.mean().item() - KEEP) <= 0.01


@pytest.mark.gpu
def test_kernels_refuse_bad_seeds_and_masks(cuda):
    """A seed of the wrong type, shape or device, an operand mask on a
    row-wise kernel, or a seed with operand masks raises before a launch."""
    ops = _operands(cuda)
    before = [_counts(getattr(m, w)) for m, w, _ in WRAPPERS.values()]
    for bad in (ops["seed"].long(), ops["seed"][:1], ops["seed"].cpu()):
        with pytest.raises(ValueError):
            pff.fused_ffn(*ops["ffn"], keep_prob=KEEP, seed=bad)
        with pytest.raises(ValueError):
            pfa.fused_sh_attention_saved(*ops["attn"], keep_prob=KEEP,
                                         seed=bad)
    with pytest.raises(ValueError):
        pff.fused_posln(*ops["posln"], keep=torch.ones(N, D, device=cuda),
                        keep_prob=KEEP)
    with pytest.raises(ValueError):
        pfa.fused_sh_attention_saved(*ops["attn"], **_drop(ops, "masks"),
                                     seed=ops["seed"])
    assert [_counts(getattr(m, w)) for m, w, _ in WRAPPERS.values()] == before
