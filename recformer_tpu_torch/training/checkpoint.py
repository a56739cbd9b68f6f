"""Checkpoints in torch format: parameters, train state for exact resume,
the k best checkpoints by a metric, and loading a foreign state dict.

Counterpart of ``save_params``/``restore_params``,
``save_train_state``/``restore_train_state``, ``TopKCheckpointManager``,
``load_torch_checkpoint`` and ``merge_params`` in
``recformer_tpu/training/checkpoint.py``, which write orbax directories.
Here every checkpoint is one ``torch.save`` file, written to a temporary
name and moved into place, so a run killed mid-write leaves the previous
file whole:

- parameters are a state dict in the HF Longformer names the port's modules
  carry, on the CPU: ``cli.evaluate_seq --ckpt`` and
  ``cli.common.maybe_load_pretrained`` read them, and the JAX package's
  ``import_torch_state_dict`` takes them;
- a train state holds the parameters, the optimizer's whole state (see
  ``AdamWSchedule.state_dict``), its micro-step count (the JAX TrainState's
  ``step``) and whatever position the caller adds.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from ..weights import strip_wrapper_prefixes


def _atomic_save(obj, path: str) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state_dict(params) -> Dict[str, torch.Tensor]:
    sd = params.state_dict() if hasattr(params, "state_dict") else params
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def save_params(path: str, params) -> None:
    """Write a module's (or a state dict's) tensors to ``path``."""
    _atomic_save(_cpu_state_dict(params), path)


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """Read a state dict saved by :func:`save_params` (CPU tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_train_state(path: str, model, optimizer, **position) -> None:
    """Parameters, optimizer state and micro-step count, plus ``position``
    (JSON-like values: where the caller's loop stands)."""
    _atomic_save({"params": _cpu_state_dict(model), "optimizer": optimizer.state_dict(),
                  "step": optimizer.micro_steps, "position": position}, path)


def restore_train_state(path: str, model, optimizer) -> dict:
    """Load a train state into ``model`` and ``optimizer`` in place (the
    optimizer keeps its parameters); returns the saved position."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["params"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    assert optimizer.micro_steps == state["step"], (optimizer.micro_steps, state["step"])
    return state["position"]


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.bin``/``.pt`` state dict on the CPU: a ``"state_dict"``
    key unwrapped, the Lightning/DeepSpeed ``_forward_module.`` and
    ``model.`` prefixes stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {strip_wrapper_prefixes(k): v for k, v in sd.items()}


def merge_params(source: Dict[str, torch.Tensor], model,
                 verbose: bool = True) -> Tuple[List[str], List[str]]:
    """The reference's ``load_state_dict(..., strict=False)``: copy every
    tensor of ``source`` whose name and shape ``model`` has, in the model's
    type; the rest of the model keeps its values. Returns the names copied
    and the names skipped."""
    own = model.state_dict()
    matched = {n: t for n, t in source.items() if n in own and own[n].shape == t.shape}
    skipped = [n for n in source if n not in matched]
    model.load_state_dict(matched, strict=False)
    if verbose:
        print(f"[import] copied {len(matched)} tensors, skipped {len(skipped)}")
        for n in skipped[:20]:
            print(f"[import]   skipped: {n}")
    return list(matched), skipped


class TopKCheckpointManager:
    """Keep the ``k`` best parameter checkpoints by a monitored metric under
    ``root``, as files named ``step{N}_m{metric:.6f}``; the worst is removed
    when there are more than ``k``. Entries already in ``root`` are read on
    construction, so a resumed run keeps competing with them."""

    def __init__(self, root: str, k: int = 5, mode: str = "max"):
        assert mode in ("max", "min")
        self.root = root
        self.k = k
        self.mode = mode
        os.makedirs(root, exist_ok=True)
        self._entries: List[Tuple[float, str]] = []
        for name in os.listdir(root):
            m = re.fullmatch(r"step\d+_m(-?[\d.]+)", name)
            if m:
                self._entries.append((float(m.group(1)), os.path.join(root, name)))

    def _key(self, entry: Tuple[float, str]) -> float:
        return entry[0] if self.mode == "max" else -entry[0]

    def save(self, params, step: int, metric: float) -> Optional[str]:
        """Save if the metric makes the top k; returns the path or None."""
        if len(self._entries) >= self.k:
            worst = min(self._entries, key=self._key)
            if self._key((metric, "")) < self._key(worst):
                return None
        path = os.path.join(self.root, f"step{step}_m{metric:.6f}")
        save_params(path, params)
        self._entries = [e for e in self._entries if e[1] != path] + [(metric, path)]
        while len(self._entries) > self.k:
            worst = min(self._entries, key=self._key)
            self._entries.remove(worst)
            if os.path.exists(worst[1]):
                os.remove(worst[1])
        return path

    def best_path(self) -> Optional[str]:
        if not self._entries:
            return None
        return max(self._entries, key=self._key)[1]
