"""The port's dropout stream (ait_tpu_torch/ops/philox.py, the plain version
of csrc/philox.cuh) and the mask dumps' plain versions: Philox4x32-10's
published known-answer vectors, the 32 x 32 -> 64-bit products, the keep
rule of the JAX kernels' `_keep_thresh`, the counter layout (tag, head,
index, group), and the dumps' independence of how many pairs or rows one
dump covers.  All exact: integer arithmetic, no tolerance.
"""

import numpy as np
import pytest
import torch

from ait_tpu_torch.ops import dropout_masks as dm
from ait_tpu_torch.ops import philox

# philox4x32-10 known-answer vectors (Random123's kat_vectors): counter,
# key, output
KAT = [((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff,) * 2,
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


def _t(v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones",
                                                       "pi"])
def test_known_answer_vectors(counter, key, want):
    out = philox.philox4x32(tuple(map(_t, counter)), tuple(map(_t, key)))
    assert tuple(int(w) for w in out) == want


def test_mulhilo_is_the_exact_64_bit_product():
    """The 16-bit-half product equals Python's exact one (what CUDA's
    `__umulhi` and a 32-bit multiply give) on edge and random words."""
    rng = np.random.RandomState(0)
    words = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF] + \
        [int(v) for v in rng.randint(0, 2 ** 32, 200, dtype=np.uint64)]
    b = torch.tensor(words, dtype=torch.int64)
    for m in (0xD2511F53, 0xCD9E8D57):
        hi, lo = philox._mulhilo(m, b)
        assert [int(v) for v in hi] == [(m * w) >> 32 for w in words]
        assert [int(v) for v in lo] == [(m * w) & 0xFFFFFFFF for w in words]


def test_keep_threshold():
    """`_keep_thresh`: round(keep_prob * 2^32), capped at 2^32 - 1."""
    assert philox.keep_threshold(0.9) == 3865470566
    assert philox.keep_threshold(1.0) == 2 ** 32 - 1
    assert philox.keep_threshold(0.5) == 2 ** 31


def test_keep_rule_and_rate():
    """keep = bits < threshold, kept at a rate within 0.01 of 0.9."""
    seed = torch.tensor([-123, 456], dtype=torch.int32)
    bits = philox.keep_bits(seed, philox.TAG_FFN, 1, 512, 512)
    mask = philox.keep_mask(seed, philox.TAG_FFN, 1, 512, 512, 0.9)
    assert torch.equal(mask, (bits < philox.keep_threshold(0.9)).float())
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    assert abs(mask.mean().item() - 0.9) < 0.01


@pytest.mark.parametrize("length", [56 * 56, 510])
def test_counter_layout(length):
    """Element e of block (tag, head, index) is word e % 4 of the Philox
    call on counter (tag, head, index, e // 4) keyed by the seed's words as
    uint32; a length that is not a multiple of 4 uses its last group in
    part."""
    seed = torch.tensor([-7, 2 ** 31 - 1], dtype=torch.int32)
    bits = philox.keep_bits(seed, philox.TAG_ATTN, 3, 5, length)
    key = (_t(2 ** 32 - 7), _t(2 ** 31 - 1))
    for h, i, e in ((0, 0, 0), (2, 4, length - 1), (1, 3, length // 2 + 1)):
        words = philox.philox4x32((_t(1), _t(h), _t(i), _t(e // 4)), key)
        assert int(bits[h, i, e]) == int(words[e % 4])


def test_streams_differ_by_tag_head_index_and_seed():
    seed = torch.tensor([1, 2], dtype=torch.int32)
    base = philox.keep_bits(seed, 1, 2, 2, 64)
    assert not torch.equal(base[0], base[1])
    assert not torch.equal(base[:, 0], base[:, 1])
    assert not torch.equal(base, philox.keep_bits(seed, 2, 2, 2, 64))
    assert not torch.equal(base, philox.keep_bits(
        torch.tensor([1, 3], dtype=torch.int32), 1, 2, 2, 64))


def test_attention_dump_layout_and_tiling_independence():
    """The JAX layouts ([H, P*Tq, Tk] and [P*Tq, D]); pair i's masks are
    the same from a dump of 4 pairs as from one of 8."""
    seed = torch.tensor([11, -12], dtype=torch.int32)
    ak4, ok4 = dm.dropout_keep_masks(seed, 4, 56, 56, 512, keep_prob=0.9)
    ak8, ok8 = dm.dropout_keep_masks(seed, 8, 56, 56, 512, keep_prob=0.9)
    assert ak8.shape == (8, 8 * 56, 56) and ok8.shape == (8 * 56, 512)
    assert torch.equal(ak4, ak8[:, :4 * 56]) and torch.equal(ok4,
                                                             ok8[:4 * 56])
    # pair 5, head 3: its [Tq, Tk] block of the tag-1 stream
    block = philox.keep_mask(seed, philox.TAG_ATTN, 8, 8, 56 * 56, 0.9)[3, 5]
    assert torch.equal(ak8[3, 5 * 56:6 * 56], block.view(56, 56))


@pytest.mark.parametrize("dump,tag", [(dm.ffn_keep_mask, philox.TAG_FFN),
                                      (dm.posln_keep_mask, philox.TAG_GLUE)])
def test_row_dumps_are_per_row(dump, tag):
    """[N, D] with a block per absolute row: the first 64 rows of an N=128
    dump are the N=64 dump; the FFN's and the glue's streams differ."""
    seed = torch.tensor([5, 6], dtype=torch.int32)
    small, big = dump(seed, 64, 512, keep_prob=0.9), dump(seed, 128, 512,
                                                          keep_prob=0.9)
    assert small.shape == (64, 512) and torch.equal(small, big[:64])
    assert torch.equal(big, philox.keep_mask(seed, tag, 1, 128, 512,
                                             0.9)[0])
    other = philox.TAG_GLUE if tag == philox.TAG_FFN else philox.TAG_FFN
    assert not torch.equal(big, philox.keep_mask(seed, other, 1, 128, 512,
                                                 0.9)[0])
