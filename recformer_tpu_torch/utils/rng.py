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

Activation recomputation runs a layer's forward a second time in the
backward and must draw there exactly what the first run drew:
:func:`capture` notes where both generators stand before the first run and
:func:`replay` runs the recomputation from there, then puts the generators
back where it found them (``torch.utils.checkpoint`` stashes only the
default generators, never these).
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


def capture(rng):
    """Where the generators of ``rng`` (a :class:`StepRNG`, or None) stand
    now: a list of (generator, state)."""
    if rng is None:
        return []
    gens = [rng.host] if rng.device is rng.host else [rng.host, rng.device]
    return [(g, g.get_state()) for g in gens]


def replay(state, fn, *args):
    """Set the generators back to ``state`` (from :func:`capture`), run
    ``fn(*args)`` and return its result, then put the generators back where
    this call found them: ``fn`` draws what it drew when ``state`` was
    captured, and the stream goes on as if it had not run again."""
    found = [(g, g.get_state()) for g, _ in state]
    for g, s in state:
        g.set_state(s)
    try:
        return fn(*args)
    finally:
        for g, s in found:
            g.set_state(s)


def dropout(x: torch.Tensor, rate: float, rng) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1/(1-rate)``; the identity when ``rng`` is None."""
    if rng is None or rate <= 0.0:
        return x
    u = torch.rand(x.shape, generator=rng.device, device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0).to(x.dtype)
