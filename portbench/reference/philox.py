"""The dropout stream of the program's training step, frozen here: Philox
4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC'11) keyed by a dropout site's two seed words and counted by (tag, head,
index, group), in plain torch integer ops.

* key = the site's two seed words ([2] int32, read as uint32);
* counter = (tag, head, index, group): tag 1 the attention probabilities,
  2 the attention output (after fc), 3 the FFN output, 4 the input glue;
  index the absolute pair (tags 1, 2) or the absolute row (tags 3, 4); head
  the attention head for tag 1, else 0;
* one Philox call gives 4 consecutive elements: element e of the index's
  block ([Tq, Tk] per head and pair for tag 1, [Tq, D] per pair for tag 2,
  [D] per row for tags 3 and 4, flattened row-major) is word e % 4 of group
  e // 4;
* keep = bits < round(keep_prob * 2^32) (capped at 2^32 - 1).

Values are held as int64 tensors of uint32 words; the 32 x 32 -> 64-bit
products are built from 16-bit halves so that nothing overflows int64.
"""

from __future__ import annotations

import torch

TAG_ATTN, TAG_OUT, TAG_FFN, TAG_GLUE = 1, 2, 3, 4


_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def keep_threshold(keep_prob: float) -> int:
    """P(bits < threshold) == keep_prob for uniform uint32 bits."""
    return min(2 ** 32 - 1, int(round(keep_prob * 2 ** 32)))


def _mulhilo(m: int, b: torch.Tensor):
    """(high, low) 32-bit words of the constant m times the uint32 words b."""
    mh, ml = m >> 16, m & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = mh * bl + ml * bh                      # < 2^33
    t = ml * bl + ((mid & 0xFFFF) << 16)         # < 2^33
    return mh * bh + (mid >> 16) + (t >> 32), t & _MASK


def philox4x32(counter, key):
    """Philox4x32-10 of uint32 words held in int64 tensors (or ints), all
    broadcast together: counter = (c0, c1, c2, c3), key = (k0, k1).
    Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def keep_bits(seed: torch.Tensor, tag: int, heads: int, blocks: int,
              length: int) -> torch.Tensor:
    """The stream's uint32 words (as int64) for `heads` x `blocks` blocks of
    `length` elements: [heads, blocks, length], block (h, i) with counter
    (tag, h, i, group).  seed is the site's [2] int32 tensor; the words come
    out on its device."""
    dev = seed.device
    key = seed.to(torch.int64) & _MASK
    groups = -(-length // 4)
    c1 = torch.arange(heads, dtype=torch.int64, device=dev)[:, None, None]
    c2 = torch.arange(blocks, dtype=torch.int64, device=dev)[None, :, None]
    c3 = torch.arange(groups, dtype=torch.int64, device=dev)[None, None, :]
    c0 = torch.full_like(c3, tag)
    words = philox4x32((c0, c1, c2, c3), (key[0], key[1]))
    words = torch.stack([w.expand(heads, blocks, groups) for w in words], -1)
    return words.reshape(heads, blocks, groups * 4)[..., :length]


def keep_mask(seed: torch.Tensor, tag: int, heads: int, blocks: int,
              length: int, keep_prob: float) -> torch.Tensor:
    """f32 0/1 keep-mask [heads, blocks, length] of the stream."""
    bits = keep_bits(seed, tag, heads, blocks, length)
    return (bits < keep_threshold(keep_prob)).to(torch.float32)
