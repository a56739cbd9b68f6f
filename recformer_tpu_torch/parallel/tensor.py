"""Tensor parallelism: Megatron-style column/row sharding over the
``model`` group.

Counterpart of ``recformer_tpu/parallel/tensor.py``, in the port's HF
Longformer parameter names (a ``torch.nn.Linear`` weight is ``(out, in)``,
the transpose of a flax kernel):

- column-parallel (the output features, i.e. heads or FFN columns, split):
  ``attention.self.{query,key,value}{,_global}`` and ``intermediate.dense``:
  weight and bias split on dim 0;
- row-parallel (the input features split, partial products summed over the
  group): ``attention.output.dense`` and the FFN's ``output.dense``: weight
  split on dim 1, the bias whole, added once after the sum;
- everything else (embeddings, LayerNorms, the pooler, the LM head) whole
  on every rank.

:func:`shard_model_tp` keeps each rank's slice of a whole model in place and
marks its attention, intermediate and block-output modules with the mesh,
so that ``models/encoder.py`` runs ``H / n`` local heads (kernels 1 and 2
at ``num_heads = H / n``) and ``FFN / n`` columns, with the ``copy_to`` /
``psum`` pair at each column-parallel input and row-parallel output.
:func:`gather_state_dict_tp` rebuilds whole tensors (for checkpoints that a
one-rank run reads); :func:`shard_state_dict_tp` cuts a whole state dict
to a rank's slice. :func:`validate_tp_config` asks for heads and FFN width
divisible by the model size; the JAX package's TPU rule (local head width a
multiple of the 128-lane tile) has no counterpart on the card.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch
from torch import nn

from .collectives import gather_list
from .mesh import MODEL_AXIS

_COLUMN = re.compile(
    r"(^|\.)(attention\.self\.(query|key|value)(_global)?|intermediate\.dense)\.(weight|bias)$")
_ROW = re.compile(r"(^|\.)(attention\.output|layer\.\d+\.output)\.dense\.weight$")


def tp_split_dim(name: str) -> Optional[int]:
    """The dim a parameter is split on under tensor parallelism (0 for
    column-parallel weights and biases, 1 for row-parallel weights), or
    None for a parameter every rank holds whole."""
    if _COLUMN.search(name):
        return 0
    if _ROW.search(name):
        return 1
    return None


def _slice(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).contiguous()


def shard_state_dict_tp(sd: Dict[str, torch.Tensor], model_rank: int,
                        n_model: int) -> Dict[str, torch.Tensor]:
    """A rank's slice of a whole state dict."""
    out = {}
    for name, t in sd.items():
        dim = tp_split_dim(name)
        out[name] = t if dim is None else _slice(t, dim, model_rank, n_model)
    return out


def gather_state_dict_tp(sd: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Whole tensors from every model rank's slices (every rank of the
    model group must call it, in the same order of names)."""
    if mesh is None or not mesh.tensor_parallel:
        return dict(sd)
    out = {}
    for name, t in sd.items():
        dim = tp_split_dim(name)
        out[name] = t if dim is None else torch.cat(gather_list(t, mesh.model_group), dim=dim)
    return out


def validate_tp_config(cfg, n_model: int) -> None:
    if n_model == 1:
        return
    if cfg.num_attention_heads % n_model:
        raise ValueError(f"num_attention_heads={cfg.num_attention_heads} not divisible by "
                         f"model size {n_model}")
    if cfg.intermediate_size % n_model:
        raise ValueError(f"intermediate_size={cfg.intermediate_size} not divisible by "
                         f"model size {n_model}")


def tp_config(cfg):
    """The config of a tensor-parallel model: attention heads sharded over
    the ``model`` group (under every ``attention_impl``)."""
    return cfg.replace(attention_head_shard_axis=MODEL_AXIS)


def deterministic_replicas() -> None:
    """Every rank of a model group computes the replicated parameters'
    gradients from the same values, so they are equal only if every kernel
    that computes them is deterministic. The card's defaults are not (some
    backward kernels accumulate in a varying order), so this turns on
    PyTorch's deterministic algorithms, raising where an op has none, and
    sets the cuBLAS workspace they need. cuBLAS reads that setting once, so
    an entry point calls this before any CUDA work; :func:`shard_model_tp`
    refuses a model on the card without it."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def _deterministic() -> bool:
    return (torch.are_deterministic_algorithms_enabled()
            and not torch.is_deterministic_algorithms_warn_only_enabled())


@torch.no_grad()
def shard_model_tp(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's slice of every split parameter of ``model`` (a whole
    model, the same on every rank) and hand the mesh to the modules that
    run sharded. A model on the card needs :func:`deterministic_replicas`
    first. Returns the model."""
    from ..models.encoder import BlockOutput, Intermediate, LongformerSelfAttention

    if any(p.is_cuda for p in model.parameters()) and not _deterministic():
        raise RuntimeError("tensor parallelism on the card needs deterministic_replicas(), "
                           "called by the entry point before any CUDA work: without it the "
                           "replicated parameters drift apart across the model group")
    validate_tp_config(model.config, mesh.n_model)
    if model.config.attention_head_shard_axis != MODEL_AXIS:
        raise ValueError("a tensor-parallel model needs tp_config(config)")
    for name, p in list(model.named_parameters()):
        dim = tp_split_dim(name)
        if dim is None:
            continue
        owner, attr = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        setattr(mod, attr, nn.Parameter(_slice(p.data, dim, mesh.model_rank, mesh.n_model),
                                        requires_grad=p.requires_grad))
    for mod in model.modules():
        if isinstance(mod, (LongformerSelfAttention, Intermediate, BlockOutput)):
            mod.tp = mesh
    return model
