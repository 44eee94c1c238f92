"""The randomness of one training forward's dropout sites (counterpart of
the JAX package's `dropout` rng stream as its modules draw from it).

`AITDetector.forward(train=True)` makes one `Dropout` and hands it down;
every dropout site asks it, in the forward's call order, either for

* `seed(device)`: the site's two seed words, a [2] int32 tensor drawn with
  `torch.randint` from the caller's generator on the generator's device (no
  host sync).  The fused kernels draw their keep-masks from it in-kernel;
  the plain versions, and the co-attention's plain path, draw the same masks
  from the Philox stream (ops/philox.py, ops/dropout_masks.py).  So the
  kernel path and the plain path see the same masks for the same generator
  state, and the sites draw in the same order on either path; or
* `take(*shapes)`: the next masks of an injected list, when the caller gave
  one (the CPU parity tests hand the port the masks they made JAX draw, one
  per `jax.random.bernoulli` call, in the same order).  A site that takes
  injected masks draws no seed.

A site draws nothing when the rate is 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class Dropout:
    """rate: the dropout probability (model.t_dropout); generator: the
    torch.Generator of the step (also the target sampling's); masks: an
    optional list of 0/1 keep-masks, one per mask the forward draws."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None,
                 masks: Optional[Sequence] = None):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1)")
        self.rate = rate
        self.keep_prob = 1.0 - rate
        self.generator = generator
        self._masks = None if masks is None else list(masks)
        self._next = 0

    @property
    def active(self) -> bool:
        return self.rate > 0.0

    def seed(self, device) -> torch.Tensor:
        g = self.generator
        gdev = g.device if g is not None else torch.device(device)
        s = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                          generator=g, device=gdev)
        return s.to(device)

    def take(self, *shapes, device=None):
        """The next len(shapes) injected masks, checked against `shapes`,
        on `device`; None when no masks were injected."""
        if self._masks is None:
            return None
        out = []
        for shape in shapes:
            if self._next >= len(self._masks):
                raise ValueError("the forward has more dropout sites than "
                                 f"the {len(self._masks)} injected masks")
            m = torch.as_tensor(self._masks[self._next])
            self._next += 1
            if tuple(m.shape) != tuple(shape):
                raise ValueError(f"injected dropout mask {self._next - 1} is "
                                 f"{tuple(m.shape)}, the site draws {shape}")
            out.append(m.to(device))
        return out


def dropping(drop: Optional[Dropout]) -> bool:
    """Whether a site draws: in training at a rate above 0."""
    return drop is not None and drop.active


def row_dropout(drop: Optional[Dropout], flat: torch.Tensor) -> dict:
    """The dropout arguments of a fused row-wise site (FFN, glue) over flat
    [N, D] rows: an injected [N, D] mask, else a seed; none at eval."""
    if not dropping(drop):
        return {}
    masks = drop.take(tuple(flat.shape), device=flat.device)
    if masks is not None:
        return {"keep": masks[0], "keep_prob": drop.keep_prob}
    return {"seed": drop.seed(flat.device), "keep_prob": drop.keep_prob}


def flax_dropout(x: torch.Tensor, keep: torch.Tensor, keep_prob: float):
    """flax's nn.Dropout given its mask: select(keep, x / keep_prob, 0) in
    x's dtype, keep_prob rounded to that dtype as jnp's weak typing does."""
    kp = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep.to(torch.bool), x / kp, x.new_zeros(()))
