"""The random streams of a training step, worked out again from the run's
seed: the reference draws what the program's step draws, so the two can
be compared step by step under dropout.

The program's documented streams (``recformer_tpu_torch/utils/rng.py`` and
``ops/window_attention.py``): a step's seed is ``fold_in(seed, micro-step)``
(splitmix64); two ``torch.Generator``s are seeded with it, one on the
device for every plain draw (pair sampling, MLM, hidden and global-row
dropout), one on the host for the attention kernels' integer seeds (on the
CPU both are one generator); the attention kernels keep column ``c`` of
row ``i`` of head ``h`` of batch row ``b`` iff word ``c & 3`` of
Philox-4x32-10 at counter ``(c >> 2, i, h, b)`` and key ``(seed, 0)`` is at
least ``floor(rate * 2**32)``. The algorithms are public (splitmix64,
Philox); the code here is written from them.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def fold_in(seed: int, step: int) -> int:
    """splitmix64 of ``(seed, step)`` packed in one word, shifted to 63 bits."""
    z = (((int(seed) & _M32) << 32) | (int(step) & _M32)) + 0x9E3779B97F4A7C15
    z &= _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


class StepDraws:
    """A step's two generators: ``dev`` for plain draws on ``device``,
    ``host`` for the kernels' seeds (one generator on the CPU)."""

    def __init__(self, seed: int, device):
        dev = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed))
        self.dev = (self.host if dev.type == "cpu"
                    else torch.Generator(dev).manual_seed(int(seed)))
        self.device = dev

    def rand(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.dev, device=self.device)

    def randint(self, high: int, *shape) -> torch.Tensor:
        return torch.randint(0, high, shape, generator=self.dev, device=self.device)

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.host))


def _mulhilo(a: int, x: torch.Tensor):
    lo_a, hi_a = a & 0xFFFF, a >> 16
    p0 = x * lo_a
    p1 = x * hi_a
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & _M32
    hi = ((p0 >> 16) + p1) >> 16
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32 with 10 rounds over int64 tensors holding 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def attention_keep(seed: int, rate: float, b, h, i, c) -> torch.Tensor:
    """The attention kernels' keep bit, broadcast over int64 ``b, h, i, c``."""
    words = philox(c >> 2, i, h, b, int(seed) & _M32, 0)
    sel = c & 3
    bits = torch.where(sel == 0, words[0], torch.where(
        sel == 1, words[1], torch.where(sel == 2, words[2], words[3])))
    return bits >= min(int(rate * 2.0 ** 32), _M32)
