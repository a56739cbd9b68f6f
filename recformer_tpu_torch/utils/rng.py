"""The random streams of a training step.

JAX threads one key through a step and splits it; the port holds two
``torch.Generator``s instead: one on the compute device for the masks that
plain PyTorch draws (hidden-state, embedding and global-row dropout, MLM and
pair sampling), and one on the CPU for the attention kernels' dropout seeds,
which the wrapper passes to the kernel as an integer without a device sync.
On the CPU the two are one generator.
"""

from __future__ import annotations

import torch


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
