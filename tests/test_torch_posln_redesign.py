"""The redesigned LayerNorm glue kernels (csrc/posln.cu `posln_kernel` and
`ln_bwd_kernel`: persistent blocks, a ring of row slots per warp, the
parameter gradients in a fixed order), on the CPU.

* The grid plan: `posln_grid` and `ln_bwd_grid` over `grid_rows` cover every
  row exactly once at the main path's row counts and at ragged ones, and
  fill the card at the main path's.
* The summation order of dln_s and dln_b: its emulation (`ln_bwd_reference`
  with `blocks`, through `ln_param_sums`) against the plain backward
  (`posln_bwd_reference`, `ffn_bwd_reference`) and against ait_tpu: its
  `fused_posln` and `fused_ffn` VJPs in interpret mode without dropout, and
  with dropout the VJPs of its `posln_reference` and `ffn_reference` fed
  the same numpy mask (the TPU's bits are not the port's Philox stream).
  All three modes of `ln_bwd`, at ragged row counts and grids from one
  block a warp-row to many rows a warp.  float32 on every side, so only the
  order of f32 sums differs: 2e-5 absolute (1e-5 relative), as
  tests/test_torch_fwd_redesign.py.
* The lanes' columns and their Philox words: emulated through
  ops/philox.py, the bits each lane draws are `philox.keep_mask`'s for the
  FFN's and the glue's tags.
* The launches, with a stand-in for the built library: `fused_posln` one
  `posln_fwd` over the planned grid; `fused_posln_bwd` one `ln_bwd` (its
  partials [blocks, 2, 512], no column-sum launch); `fused_ffn_bwd` its two
  products, `ln_bwd` on y2, four products and the bias sums; and a CPU
  tensor never builds a kernel.
* `gpu`-marked: both kernels against their plain versions on the card in
  every type combination and mode, at the main path's and ragged row
  counts, dln_s and dln_b bit-equal over two calls, and no launch at
  N = 0.  This file imports JAX only inside the tests that compare with it,
  so on a machine with a GPU and no JAX the card tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_posln_redesign.py
"""

import numpy as np
import pytest
import torch

from ait_tpu_torch.ops import _build, _gemm, philox
from ait_tpu_torch.ops import fused_ffn as pff

from test_torch_fwd_redesign import FakeLibrary, T

D, HID = 128, 256            # narrow widths for the interpret runs
KEEP = 0.9
CLOSE = dict(rtol=1e-5, atol=2e-5)
SMS = 132                    # an H100 SXM's streaming multiprocessors
# the main path's row counts (the glue's decoder, the train step's encoder
# and FFN decoder rows, the eval encoder) and ragged ones
MAIN_N = [512, 57344, 65536, 134400]
RAGGED_N = [1, 7, 8 * 1000 + 3]
# (kernel, bytes of x, bytes of the addend): the forward in f32 and bf16,
# the backward's three type combinations (glue bf16, FFN, f32)
KINDS = [("fwd", 2, 2), ("fwd", 4, 4), ("bwd", 2, 2), ("bwd", 2, 4),
         ("bwd", 4, 4)]


def _grid(kind, n, sms=SMS):
    name, xb, ab = kind
    return (pff.posln_grid(n, sms, xb) if name == "fwd"
            else pff.ln_bwd_grid(n, sms, xb, ab))


# ----------------------------------------------------------- the grid plan


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}{k[2]}")
@pytest.mark.parametrize("n", MAIN_N + RAGGED_N)
def test_grid_covers_every_row_once(kind, n):
    blocks = _grid(kind, n)
    assert 1 <= blocks <= -(-n // pff.LN_WARPS)
    walks = pff.grid_rows(blocks, n)
    assert len(walks) == blocks * pff.LN_WARPS
    rows = np.concatenate([np.asarray(r, np.int64) for r in walks.values()])
    assert rows.size == n
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
    for (b, w), r in walks.items():
        assert list(r) == list(range(b * pff.LN_WARPS + w, n,
                                     blocks * pff.LN_WARPS))


@pytest.mark.parametrize("kind,per_sm", [(KINDS[0], 3), (KINDS[1], 2),
                                         (KINDS[2], 2), (KINDS[3], 2),
                                         (KINDS[4], 1)],
                         ids=lambda k: f"{k[0]}{k[1]}{k[2]}"
                         if isinstance(k, tuple) else str(k))
def test_grid_fills_the_card_at_the_main_path_rows(kind, per_sm):
    """At the main path's large row counts every SM holds as many blocks
    as the rings of row slots let it (the forward's __launch_bounds__ asks
    for 3, the backward's for 2), each warp walking many rows; the
    glue's decoder (512 rows) takes one row a warp."""
    name, xb, ab = kind
    # a slot holds a row of each array read: x and pos; x, the addend, g
    slot = pff.KERNEL_D * (xb + ab + (xb if name == "bwd" else 0))
    ring = pff.LN_WARPS * pff.LN_STAGES * slot
    assert per_sm * (ring + 1024) <= pff.SM_SHARED_BYTES
    for n in MAIN_N[1:]:
        assert _grid(kind, n) == SMS * per_sm
    assert _grid(kind, 512) == 512 // pff.LN_WARPS


# ------------------------------------------------- the fixed summation order


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **CLOSE,
                               err_msg=name)


def _mask(rng, n, d):
    return (rng.rand(n, d) < KEEP).astype(np.float32)


# (rows, position period): ragged counts, the period below and at n
POSLN_NT = [(7, 7), (35, 7), (99, 33)]
FFN_N = [7, 35, 99]
# SMs for the emulated grid: 1 (two blocks, many rows a warp) or an H100's
# (one row a warp at these row counts)
GRID_SMS = [1, SMS]


@pytest.mark.parametrize("sms", GRID_SMS)
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("n,t", POSLN_NT)
def test_glue_fixed_order_matches_plain_and_jax(n, t, dropout, sms):
    import jax
    import jax.numpy as jnp

    from ait_tpu.ops import pallas_ffn as jpf

    rng = np.random.RandomState(n + t + dropout)
    x = rng.randn(n, D).astype(np.float32)
    pos = rng.randn(t, D).astype(np.float32)
    ln_s = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    ln_b = (0.1 * rng.randn(D)).astype(np.float32)
    g = rng.randn(n, D).astype(np.float32)
    keep = _mask(rng, n, D) if dropout else None
    blocks = pff.ln_bwd_grid(n, sms, 4, 4)
    mode = pff._LN_GLUE if dropout else pff._LN_PLAIN
    dx, ds, db, dy2 = pff.ln_bwd_reference(
        T(x), T(pos), t, T(ln_s), T(g), mode,
        keep=None if keep is None else T(keep), keep_prob=KEEP,
        blocks=blocks)
    assert dy2 is None
    drop = dict(keep=T(keep), keep_prob=KEEP) if dropout else {}
    plain = pff.posln_bwd_reference(T(x), T(pos), T(ln_s), T(ln_b), T(g),
                                    **drop)
    for name, a, b in zip(("dx", "dln_s", "dln_b"), (dx, ds, db),
                          (plain[0], plain[2], plain[3])):
        _close(a, b, f"against posln_bwd_reference: {name}")
    ja = [jnp.asarray(a) for a in (x, pos, ln_s, ln_b)]
    if dropout:
        _, vjp = jax.vjp(lambda *a: jpf.posln_reference(
            *a, keep=jnp.asarray(keep), keep_prob=KEEP), *ja)
    else:
        seed = jnp.zeros((2,), jnp.int32)
        _, vjp = jax.vjp(lambda *a: jpf.fused_posln(*a, seed, 1.0, True),
                         *ja)
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(("dx", "dln_s", "dln_b"), (dx, ds, db),
                          (want[0], want[2], want[3])):
        _close(a, b, f"against ait_tpu: {name}")


def _ffn_y2(x, w1, b1, w2, b2):
    """The FFN's pre-dropout output, f32 (the addend `ln_bwd` gets)."""
    return torch.relu(x @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("sms", GRID_SMS)
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("n", FFN_N)
def test_ffn_fixed_order_matches_plain_and_jax(n, dropout, sms):
    import jax
    import jax.numpy as jnp

    from ait_tpu.ops import pallas_ffn as jpf

    rng = np.random.RandomState(2 * n + dropout)
    args = [rng.randn(n, D).astype(np.float32),
            (rng.randn(D, HID) * D ** -0.5).astype(np.float32),
            (0.05 * rng.randn(HID)).astype(np.float32),
            (rng.randn(HID, D) * HID ** -0.5).astype(np.float32),
            (0.05 * rng.randn(D)).astype(np.float32),
            (1 + 0.1 * rng.randn(D)).astype(np.float32),
            (0.1 * rng.randn(D)).astype(np.float32)]
    g = rng.randn(n, D).astype(np.float32)
    keep = _mask(rng, n, D) if dropout else None
    t = [T(a) for a in args]
    blocks = pff.ln_bwd_grid(n, sms, 2, 4)
    mode = pff._LN_FFN if dropout else pff._LN_PLAIN
    dy, ds, db, dy2 = pff.ln_bwd_reference(
        t[0], _ffn_y2(*t[:5]), n, t[5], T(g), mode,
        keep=None if keep is None else T(keep), keep_prob=KEEP,
        blocks=blocks)
    assert (dy2 is not None) == dropout
    drop = dict(keep=T(keep), keep_prob=KEEP) if dropout else {}
    plain = pff.ffn_bwd_reference(*t, T(g), **drop)
    _close(ds, plain[5], "against ffn_bwd_reference: dln_s")
    _close(db, plain[6], "against ffn_bwd_reference: dln_b")
    ja = [jnp.asarray(a) for a in args]
    if dropout:
        _, vjp = jax.vjp(lambda *a: jpf.ffn_reference(
            *a, keep=jnp.asarray(keep), keep_prob=KEEP), *ja)
    else:
        seed = jnp.zeros((2,), jnp.int32)
        _, vjp = jax.vjp(lambda *a: jpf.fused_ffn(*a, seed, 1.0, True), *ja)
    want = vjp(jnp.asarray(g))
    _close(ds, want[5], "against ait_tpu: dln_s")
    _close(db, want[6], "against ait_tpu: dln_b")


@pytest.mark.parametrize("n,blocks", [(1, 1), (7, 1), (300, 2), (8003, 5),
                                      (8003, 40)])
def test_param_sums_follow_the_grid_order(n, blocks):
    """`ln_param_sums` adds in the kernels' order: equal to a literal
    emulation (warps' rows, then the block's warps, then the second pass's
    warps) to the bit, and to float64 sums within f32 rounding."""
    rng = np.random.RandomState(n + blocks)
    g = torch.from_numpy(rng.randn(n, 16).astype(np.float32))
    xh = torch.from_numpy(rng.randn(n, 16).astype(np.float32))
    ds, db = pff.ln_param_sums(g, xh, blocks)
    walks = pff.grid_rows(blocks, n)
    for got, fma in ((ds, True), (db, False)):
        warp = {}
        for key, rows in walks.items():
            acc = torch.zeros(16, dtype=torch.float32)
            for r in rows:
                acc = ((acc.double() + g[r].double() * xh[r].double()).float()
                       if fma else acc + g[r])
            warp[key] = acc
        part = []
        for b in range(blocks):
            acc = torch.zeros(16, dtype=torch.float32)
            for w in range(pff.LN_WARPS):
                acc = acc + warp[(b, w)]
            part.append(acc)
        total = torch.zeros(16, dtype=torch.float32)
        for v in range(pff.LN_REDUCE_WARPS):
            acc = torch.zeros(16, dtype=torch.float32)
            for r in range(v, blocks, pff.LN_REDUCE_WARPS):
                acc = acc + part[r]
            total = total + acc
        assert torch.equal(got, total)
        exact = ((g.double() * xh.double()) if fma else g.double()).sum(0)
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------ lanes and Philox


def lane_columns(lane):
    """The 16 columns lane `lane` of a warp owns in csrc/posln.cu's kernels
    (`lane_load`, `keep_bits`): element i is column (i // 4) * 128 +
    lane * 4 + i % 4, word i % 4 of the row's Philox group
    (i // 4) * 32 + lane."""
    return [(i // 4) * 128 + lane * 4 + i % 4 for i in range(16)]


def test_lane_columns_tile_the_row_in_philox_groups():
    cols = [lane_columns(lane) for lane in range(32)]
    assert sorted(c for lane in cols for c in lane) == list(range(512))
    for lane, cs in enumerate(cols):
        for i, c in enumerate(cs):
            # group (i // 4) * 32 + lane, word i % 4: the stream's c // 4, c % 4
            assert c // 4 == (i // 4) * 32 + lane and c % 4 == i % 4


@pytest.mark.parametrize("tag", [philox.TAG_FFN, philox.TAG_GLUE])
def test_lane_keep_bits_are_the_streams(tag):
    """The kernels' `keep_bits`: lane l draws group (i // 4) * 32 + l of
    block (tag, 0, row) and keeps element i where word i % 4 is below the
    threshold; laid out by `lane_columns`, that is philox.keep_mask."""
    seed = torch.tensor([-123456789, 987654321], dtype=torch.int32)
    want = philox.keep_mask(seed, tag, 1, 201, 512, KEEP)[0]
    key = tuple(int(k) & 0xFFFFFFFF for k in seed.tolist())
    thresh = philox.keep_threshold(KEEP)
    lanes = torch.arange(32, dtype=torch.int64)
    cols = torch.arange(512, dtype=torch.int64)
    for row in (57343, 134399):       # the stream's rule at the far rows
        words = torch.stack(philox.philox4x32((tag, 0, row, cols // 4), key))
        want = torch.cat([want, (words.gather(0, (cols % 4)[None])[0] <
                                 thresh).float()[None]])
    rows = [0, 1, 5, 77, 200, 57343, 134399]
    for i, row in enumerate(rows):
        got = torch.empty(512)
        for j in range(4):
            words = philox.philox4x32((tag, 0, row, j * 32 + lanes), key)
            for e in range(4):
                kept = (words[e] < thresh).float()
                for lane in range(32):
                    got[lane_columns(lane)[4 * j + e]] = kept[lane]
        assert torch.equal(got, want[row if row <= 200 else 201 + i - 5]), row


# ------------------------------------------------------- launches, faked


@pytest.fixture
def fake_card(monkeypatch):
    """The launchers' view of a card with 132 SMs: the library a stand-in,
    the products and column sums recorded in one event list with the
    library's entries (their results are the plain ones: the operands lie
    on the CPU here), and every float32 allocation's shape."""
    lib, allocs = FakeLibrary(), []
    events = lib.calls
    real_gemm, real_colsum, real_empty = _gemm.gemm, _gemm.colsum, torch.empty

    def gemm(layout, a, b, **kw):
        out = real_gemm(layout, a, b, **kw)
        events.append(("gemm", (layout, a, b, kw, out)))
        return out

    def colsum(x):
        events.append(("colsum", (x,)))
        return real_colsum(x)

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        allocs.append(out)
        return out

    monkeypatch.setattr(_build, "load", lambda stem, funcs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(pff, "device_sms", lambda device: SMS)
    monkeypatch.setattr(_gemm, "gemm", gemm)
    monkeypatch.setattr(_gemm, "colsum", colsum)
    monkeypatch.setattr(torch, "empty", empty)
    return events, allocs


def _rows_inputs(n, t, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return ([T(rng.randn(n, 512).astype(np.float32)).to(dtype),
             T(rng.randn(t, 512).astype(np.float32)).to(dtype),
             T((1 + 0.1 * rng.randn(512)).astype(np.float32)),
             T((0.1 * rng.randn(512)).astype(np.float32))],
            T(rng.randn(n, 512).astype(np.float32)).to(dtype))


DROPS = {False: (None, 0, 1.0), True: (4096, philox.keep_threshold(KEEP),
                                       1.0 / KEEP)}


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_posln_forward_launches_once_over_the_grid(dtype, dropout,
                                                   fake_card):
    events, _ = fake_card
    n, t = 8003, 7
    (x, pos, ln_s, ln_b), _ = _rows_inputs(n, t, dtype)
    out = torch.empty_like(x)
    pff._posln_launch(x, pos, ln_s, ln_b, out, DROPS[dropout])
    assert [e[0] for e in events] == ["posln_fwd"]
    a = events[0][1]
    assert a[0] == int(dtype == torch.bfloat16)
    assert a[1:6] == tuple(v.data_ptr() for v in (x, pos, ln_s, ln_b, out))
    assert a[6:9] == (n, t, pff.posln_grid(n, SMS, x.element_size()))
    assert a[9:12] == DROPS[dropout] and a[12] == 0


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t", [(57344, 56), (512, 64), (99, 33)])
def test_posln_bwd_launches_one_ln_bwd(n, t, dtype, dropout, fake_card):
    events, allocs = fake_card
    (x, pos, ln_s, _), g = _rows_inputs(n, t, dtype)
    allocs.clear()
    dx, dpos, ds, db = pff._posln_bwd_launches(x, pos, ln_s, g,
                                               KEEP if dropout else 1.0,
                                               DROPS[dropout])
    assert [e[0] for e in events] == ["ln_bwd"]          # no column sums
    a = events[0][1]
    bf = int(dtype == torch.bfloat16)
    assert a[:3] == (bf, bf, bf)
    assert a[3:6] == (x.data_ptr(), pos.data_ptr(), t)
    assert a[6:8] == (ln_s.data_ptr(), g.data_ptr())
    assert a[8] == dx.data_ptr() and dx.dtype == dtype and dx.shape == x.shape
    blocks = pff.ln_bwd_grid(n, SMS, x.element_size(), pos.element_size())
    parts = [p for p in allocs if p.data_ptr() == a[9]]
    assert len(parts) == 1 and tuple(parts[0].shape) == (blocks, 2, 512)
    assert parts[0].dtype == torch.float32
    assert a[10:12] == (ds.data_ptr(), db.data_ptr())
    assert ds.shape == db.shape == (512,)
    assert a[12:15] == (n, blocks, pff._LN_GLUE if dropout else pff._LN_PLAIN)
    assert a[15:18] == DROPS[dropout] and a[18] is None and a[19] == 0
    assert not dpos.any() and dpos.shape == pos.shape


@pytest.mark.parametrize("dropout", [False, True])
def test_ffn_bwd_launch_order(dropout, fake_card):
    """Two recompute products, `ln_bwd` on y2 (f32 out, the FFN's mode with
    dropout, dy2 beside dy), four gradient products, the two bias column
    sums on dy1 and dy2; one `ln_launches` count."""
    events, allocs = fake_card
    n, dt = 7, torch.bfloat16
    rng = np.random.RandomState(3)
    f = [T(rng.randn(*s).astype(np.float32) * sc) for s, sc in (
        ((n, 512), 1.0), ((512, 2048), 0.04), ((2048,), 0.05),
        ((2048, 512), 0.02), ((512,), 0.05), ((512,), 1.0))]
    x, w1, b1, w2, b2, ln_s = f
    x, w1, w2 = x.to(dt), w1.to(dt), w2.to(dt)
    g = T(rng.randn(n, 512).astype(np.float32)).to(dt)
    before = pff.fused_ffn_bwd.ln_launches
    allocs.clear()
    out = pff._ffn_bwd_launches(x, w1, b1, w2, b2, ln_s, g,
                                KEEP if dropout else 1.0, DROPS[dropout])
    assert pff.fused_ffn_bwd.ln_launches == before + 1
    assert [e[0] for e in events] == (["gemm"] * 2 + ["ln_bwd"] +
                                      ["gemm"] * 4 + ["colsum"] * 2)
    (l1, a1, b1_, kw1, y1), (l2, a2, b2_, kw2, y2) = (e[1] for e in events[:2])
    assert (l1, l2) == (_gemm.NN, _gemm.NN)
    assert a1 is x and b1_ is w1 and kw1.get("relu") and a2 is y1
    assert b2_ is w2 and y2.dtype == torch.float32
    a = events[2][1]
    assert a[:3] == (1, 0, 0)                            # bf16 x, f32 y2, f32 out
    assert a[3:6] == (x.data_ptr(), y2.data_ptr(), n)
    assert a[6:8] == (ln_s.data_ptr(), g.data_ptr())
    blocks = pff.ln_bwd_grid(n, SMS, 2, 4)
    assert a[12:15] == (n, blocks, pff._LN_FFN if dropout else pff._LN_PLAIN)
    assert a[15:18] == DROPS[dropout]
    dy = [t for t in allocs if t.data_ptr() == a[8]][0]
    assert dy.dtype == torch.float32 and dy.shape == (n, 512)
    if dropout:
        dy2 = [t for t in allocs if t.data_ptr() == a[18]][0]
        assert dy2.dtype == torch.float32 and dy2.shape == (n, 512)
    else:
        assert a[18] is None
        dy2 = dy
    layouts = [e[1][0] for e in events[3:7]]
    assert layouts == [_gemm.NT, _gemm.NT, _gemm.TN, _gemm.TN]
    assert events[4][1][3]["cadd"] is dy                 # the residual's dy
    assert events[6][1][2] is dy2                        # dw2 = y1^T dy2
    dy1 = events[3][1][4]
    assert events[7][1][0] is dy1 and events[8][1][0] is dy2
    assert out[5].data_ptr() == a[10] and out[6].data_ptr() == a[11]


def test_cpu_tensors_build_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor built a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_gemm, "_lib", refuse)
    (x, pos, ln_s, ln_b), g = _rows_inputs(21, 7, torch.float32)
    seed = torch.tensor([5, 6], dtype=torch.int32)
    for kw in ({}, dict(seed=seed, keep_prob=KEEP)):
        torch.testing.assert_close(pff.fused_posln(x, pos, ln_s, ln_b, **kw),
                                   pff.posln_reference(x, pos, ln_s, ln_b,
                                                       **kw))
        for a, b in zip(pff.fused_posln_bwd(x, pos, ln_s, ln_b, g, **kw),
                        pff.posln_bwd_reference(x, pos, ln_s, ln_b, g, **kw)):
            torch.testing.assert_close(a, b)
        rng = np.random.RandomState(1)
        f = [x, T(rng.randn(512, 2048).astype(np.float32) * 0.04),
             T(rng.randn(2048).astype(np.float32) * 0.05),
             T(rng.randn(2048, 512).astype(np.float32) * 0.02),
             T(rng.randn(512).astype(np.float32) * 0.05), ln_s, ln_b]
        for a, b in zip(pff.fused_ffn_bwd(*f, g, **kw),
                        pff.ffn_bwd_reference(*f, g, **kw)):
            torch.testing.assert_close(a, b)


# --------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (csrc/posln.cu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


def _err(got, want):
    """f32: max abs error; bf16: over max(1, |want|) (one bf16 ulp of a
    unit value is 2^-8)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp(min=1.0)
    return diff.max().item()


# chip_smoke.py's gates: f32 forward 2e-3 abs, backward 5e-3 of max
# |plain|; bf16 forward 2 ulps (the final rounding may flip), backward 2e-2
FWD_TOL = {torch.float32: 2e-3, torch.bfloat16: 2.0 ** -6}
BWD_REL = {torch.float32: 5e-3, torch.bfloat16: 2e-2}
CARD_NT = [(57344, 56), (512, 64), (8003, 53), (1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t", CARD_NT)
def test_card_posln_forward(n, t, dtype, dropout, cuda):
    (x, pos, ln_s, ln_b), _ = _rows_inputs(n, t, dtype)
    a = [v.to(cuda) for v in (x, pos, ln_s, ln_b)]
    kw = (dict(seed=torch.tensor([3, -4], dtype=torch.int32, device=cuda),
               keep_prob=KEEP) if dropout else {})
    got = pff.fused_posln(*a, **kw)
    assert _err(got, pff.posln_reference(*a, **kw)) <= FWD_TOL[dtype]
    assert torch.equal(got, pff.fused_posln(*a, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t", CARD_NT)
def test_card_posln_backward(n, t, dtype, dropout, cuda):
    (x, pos, ln_s, ln_b), g = _rows_inputs(n, t, dtype)
    a = [v.to(cuda) for v in (x, pos, ln_s, ln_b, g)]
    kw = (dict(seed=torch.tensor([3, -4], dtype=torch.int32, device=cuda),
               keep_prob=KEEP) if dropout else {})
    got = pff.fused_posln_bwd(*a, **kw)
    for u, v in zip(got, pff.posln_bwd_reference(*a, **kw)):
        if v.any():
            assert _rel(u, v) <= BWD_REL[dtype]
        else:
            assert not u.any()
    again = pff.fused_posln_bwd(*a, **kw)
    assert torch.equal(got[2], again[2]) and torch.equal(got[3], again[3])


# every type combination the C entry takes (x and g, the addend, dx) in
# each mode, with a position period that does not divide the rows
COMBOS = [(torch.float32, torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("types", COMBOS, ids=["fff", "bbb", "bff"])
@pytest.mark.parametrize("n,period", [(65536, 65536), (8003, 53), (1, 1)])
def test_card_ln_bwd_every_type_and_mode(n, period, types, mode, cuda):
    tx, ta, to = types
    rng = np.random.RandomState(n + mode)
    x = T(rng.randn(n, 512).astype(np.float32)).to(cuda, tx)
    add = T(rng.randn(period, 512).astype(np.float32)).to(cuda, ta)
    g = T(rng.randn(n, 512).astype(np.float32)).to(cuda, tx)
    ln_s = T((1 + 0.1 * rng.randn(512)).astype(np.float32)).to(cuda)
    seed = torch.tensor([11, 12], dtype=torch.int32, device=cuda)
    drop, keep = (None, 0, 1.0), None
    if mode:
        drop = (seed.data_ptr(), philox.keep_threshold(KEEP), 1.0 / KEEP)
        tag = philox.TAG_GLUE if mode == pff._LN_GLUE else philox.TAG_FFN
        keep = philox.keep_mask(seed, tag, 1, n, 512, KEEP).view(n, 512)
    got = pff._ln_bwd(x, add, period, ln_s, g, to, mode, drop)
    want = pff.ln_bwd_reference(x, add, period, ln_s, g, mode, keep, KEEP,
                                out_dtype=to)
    rel = BWD_REL[torch.bfloat16 if to == torch.bfloat16 else
                  torch.float32]
    for u, v in zip(got, want):
        assert (u is None) == (v is None)
        if u is not None:
            assert _rel(u, v) <= rel
    again = pff._ln_bwd(x, add, period, ln_s, g, to, mode, drop)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


@pytest.mark.gpu
def test_card_no_rows_launches_nothing(cuda):
    (x, pos, ln_s, ln_b), g = _rows_inputs(0, 7, torch.bfloat16)
    a = [v.to(cuda) for v in (x, pos, ln_s, ln_b)]
    before = (pff.fused_posln.launches, pff.fused_posln_bwd.launches)
    assert pff.fused_posln(*a).shape == (0, 512)
    dx, dpos, ds, db = pff.fused_posln_bwd(*a, g.to(cuda))
    assert dx.shape == (0, 512) and not ds.any() and not db.any()
    assert (pff.fused_posln.launches, pff.fused_posln_bwd.launches) == before
