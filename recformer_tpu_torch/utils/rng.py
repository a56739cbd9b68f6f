"""The random streams of a training step.

JAX threads one key through a step and splits it; the port holds two
``torch.Generator``s instead: one on the compute device for the masks that
plain PyTorch draws (hidden-state, embedding and global-row dropout, MLM and
pair sampling), and one on the CPU for the attention kernels' dropout seeds,
which the wrapper passes to the kernel as an integer without a device sync.
On the CPU the two are one generator.

A step whose draws must not depend on what ran before it (so that a resumed
run draws what the uninterrupted run drew) makes its ``StepRNG`` from
``fold_in(seed, step)``, as JAX folds the step into its key.
"""

from __future__ import annotations

import torch


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, step: int) -> int:
    """A 63-bit seed from ``(seed, step)``: splitmix64 of the two packed in
    one word, so neighbouring steps get unrelated streams."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class StepRNG:
    def __init__(self, seed: int, device="cpu"):
        dev = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed))
        if dev.type == "cpu":
            self.device = self.host
        else:
            self.device = torch.Generator(dev).manual_seed(int(seed))


def dropout(x: torch.Tensor, rate: float, rng) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1/(1-rate)``; the identity when ``rng`` is None."""
    if rng is None or rate <= 0.0:
        return x
    u = torch.rand(x.shape, generator=rng.device, device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0).to(x.dtype)
