"""Carry weights between the JAX package's flax tree and the port.

The port's parameters carry HF Longformer names; the flax tree uses the JAX
package's module paths. The map between the two, and which leaves are dense
kernels stored transposed (flax ``(in, out)`` vs torch ``(out, in)``), is
the one ``recformer_tpu/training/checkpoint.py`` keeps in
``_torch_name_to_flax_path``; this module holds its own copy.

Three trees are carried: a task model's (the backbone under
``longformer``, with the MLM head ``lm_head`` or the fraud head
``fc1``-``fc3``), and the bare backbone, ``RecformerModel``'s own, whose
torch names have no ``longformer.`` prefix and whose flax tree is the task
tree's ``longformer`` subtree (``cli.convert_ckpt`` writes it so).

Both encoder layouts of the flax tree are handled: the unrolled
``encoder/layer_{i}/...`` siblings and the stacked ``scan_layers`` layout
``encoder/layers/layer/...``, whose leaves carry a leading
``(num_layers,)`` axis. :func:`stack_layer_params` and
:func:`unstack_layer_params` are the port's own copy of the JAX package's
functions of the same names (``training/checkpoint.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# torch suffix -> (flax path suffix, transposed dense kernel?)
_EMBEDDINGS = {
    "word_embeddings.weight": (("word_embeddings", "embedding"), False),
    "position_embeddings.weight": (("position_embeddings", "embedding"), False),
    "token_type_embeddings.weight": (("token_type_embeddings", "embedding"), False),
    "item_position_embeddings.weight": (("item_position_embeddings", "embedding"), False),
    "LayerNorm.weight": (("LayerNorm", "scale"), False),
    "LayerNorm.bias": (("LayerNorm", "bias"), False),
}
_LAYER = {
    "attention.output.dense.weight": (("attention", "output_dense", "kernel"), True),
    "attention.output.dense.bias": (("attention", "output_dense", "bias"), False),
    "attention.output.LayerNorm.weight": (("attention", "output_LayerNorm", "scale"), False),
    "attention.output.LayerNorm.bias": (("attention", "output_LayerNorm", "bias"), False),
    "intermediate.dense.weight": (("ffn", "intermediate_dense", "kernel"), True),
    "intermediate.dense.bias": (("ffn", "intermediate_dense", "bias"), False),
    "output.dense.weight": (("ffn", "output_dense", "kernel"), True),
    "output.dense.bias": (("ffn", "output_dense", "bias"), False),
    "output.LayerNorm.weight": (("ffn", "output_LayerNorm", "scale"), False),
    "output.LayerNorm.bias": (("ffn", "output_LayerNorm", "bias"), False),
}
for _proj in ("query", "key", "value", "query_global", "key_global", "value_global"):
    _LAYER[f"attention.self.{_proj}.weight"] = (("attention", "self", _proj, "kernel"), True)
    _LAYER[f"attention.self.{_proj}.bias"] = (("attention", "self", _proj, "bias"), False)
_LM_HEAD = {
    "lm_head.dense.weight": (("lm_head", "dense", "kernel"), True),
    "lm_head.dense.bias": (("lm_head", "dense", "bias"), False),
    "lm_head.layer_norm.weight": (("lm_head", "layer_norm", "scale"), False),
    "lm_head.layer_norm.bias": (("lm_head", "layer_norm", "bias"), False),
    "lm_head.bias": (("lm_head", "bias"), False),
}
# the fraud head's three dense layers (flax ``fc1``-``fc3``)
_FRAUD_HEAD = {}
for _i in (1, 2, 3):
    _FRAUD_HEAD[f"fc{_i}.weight"] = ((f"fc{_i}", "kernel"), True)
    _FRAUD_HEAD[f"fc{_i}.bias"] = ((f"fc{_i}", "bias"), False)
_HEADS = {**_LM_HEAD, **_FRAUD_HEAD}
_EMBEDDINGS_INV = {path: (name, tr) for name, (path, tr) in _EMBEDDINGS.items()}
_LAYER_INV = {path: (name, tr) for name, (path, tr) in _LAYER.items()}
_HEADS_INV = {path: (name, tr) for name, (path, tr) in _HEADS.items()}


def strip_wrapper_prefixes(name: str) -> str:
    """A parameter name without the Lightning/DeepSpeed wrappers'
    ``_forward_module.`` and ``model.`` prefixes."""
    return re.sub(r"^model\.", "", re.sub(r"^_forward_module\.", "", name))


def torch_name_to_flax_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """(flax path, transpose) of a torch Longformer/Recformer parameter name,
    a task model's or the bare backbone's; KeyError for a name with no
    counterpart."""
    n = strip_wrapper_prefixes(name)
    m = re.match(r"^(longformer\.)?embeddings\.(.+)$", n)
    if m and m.group(2) in _EMBEDDINGS:
        path, tr = _EMBEDDINGS[m.group(2)]
        return ("longformer",) * bool(m.group(1)) + ("embeddings",) + path, tr
    m = re.match(r"^(longformer\.)?encoder\.layer\.(\d+)\.(.+)$", n)
    if m and m.group(3) in _LAYER:
        path, tr = _LAYER[m.group(3)]
        return (("longformer",) * bool(m.group(1))
                + ("encoder", f"layer_{int(m.group(2))}") + path, tr)
    if n in _HEADS:
        return _HEADS[n]
    raise KeyError(name)


def flax_path_to_torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """Inverse of :func:`torch_name_to_flax_path`."""
    if path in _HEADS_INV:
        return _HEADS_INV[path]
    prefix, rest = ("longformer.", path[1:]) if path[:1] == ("longformer",) else ("", path)
    if rest[:1] == ("embeddings",) and rest[1:] in _EMBEDDINGS_INV:
        name, tr = _EMBEDDINGS_INV[rest[1:]]
        return f"{prefix}embeddings.{name}", tr
    if len(rest) > 2 and rest[0] == "encoder":
        m = re.fullmatch(r"layer_(\d+)", rest[1])
        if m and rest[2:] in _LAYER_INV:
            name, tr = _LAYER_INV[rest[2:]]
            return f"{prefix}encoder.layer.{int(m.group(1))}.{name}", tr
    raise KeyError("/".join(path))


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def _is_unrolled_layer_dict(d) -> bool:
    return (isinstance(d, dict) and "layer_0" in d
            and all(re.fullmatch(r"layer_\d+", k) for k in d))


def _is_stacked_layer_dict(d) -> bool:
    return isinstance(d, dict) and set(d) == {"layer"} and isinstance(d["layer"], dict)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_leaves(trees):
    """One tree of the same structure whose leaves stack those of ``trees``
    along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def stack_layer_params(tree):
    """Unrolled encoder layers (``layer_0..layer_{n-1}`` under ``encoder``)
    in the ``scan_layers`` layout (``layers/layer`` with a leading
    ``(num_layers,)`` axis on every leaf). Walks the whole tree."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "encoder" and _is_unrolled_layer_dict(v):
            layers = [stack_layer_params(v[f"layer_{i}"]) for i in range(len(v))]
            out[k] = {"layers": {"layer": _stack_leaves(layers)}}
        else:
            out[k] = stack_layer_params(v)
    return out


def unstack_layer_params(tree):
    """Inverse of :func:`stack_layer_params`."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if (k == "encoder" and isinstance(v, dict) and "layers" in v
                and _is_stacked_layer_dict(v["layers"])):
            stacked = v["layers"]["layer"]
            n = np.asarray(next(iter(_flatten(stacked).values()))).shape[0]
            out[k] = {f"layer_{i}": _map_leaves(lambda x, i=i: np.asarray(x)[i], stacked)
                      for i in range(n)}
        else:
            out[k] = unstack_layer_params(v)
    return out


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters (``{'params': ...}`` or a bare tree of
    numpy arrays, the encoder unrolled or stacked) as the port's state dict.
    Raises KeyError on a leaf the port has no name for."""
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    tree = unstack_layer_params(tree)
    sd = {}
    for path, arr in _flatten(tree).items():
        name, transpose = flax_path_to_torch_name(path)
        a = np.asarray(arr)
        sd[name] = torch.from_numpy(np.array(a.T if transpose else a))
    return sd


def to_flax_params(state_dict: Dict[str, torch.Tensor], stacked: bool = False):
    """The port's state dict as a bare flax tree of numpy arrays; with
    ``stacked`` the encoder takes the ``scan_layers`` layout."""
    root: dict = {}
    for name, tensor in state_dict.items():
        path, transpose = torch_name_to_flax_path(name)
        a = tensor.detach().cpu().numpy()
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(a.T if transpose else a)
    return stack_layer_params(root) if stacked else root


_HF_EXPERT = re.compile(r"^(.*\.mlp\.experts)\.(\d+)\.(gate|up|down)_proj\.weight$")


def deepseek_v3_from_hf(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Hugging Face ``DeepseekV3Model``/``DeepseekV3ForCausalLM`` state dict
    under the port's names (``models/deepseek_v3.py``): ``model.`` read as
    the heads' ``longformer.``, each MoE layer's per-expert
    ``mlp.experts.E.{gate,up,down}_proj.weight`` stacked into
    ``mlp.experts.gate_up_proj`` ``(E, 2I, hs)`` (gate rows, then up rows)
    and ``mlp.experts.down_proj`` ``(E, hs, I)``; the LM head, which ranking
    does not read, left out."""
    out, experts = {}, {}
    for name, t in state_dict.items():
        if name.startswith("lm_head."):
            continue
        name = "longformer." + (name[len("model."):] if name.startswith("model.") else name)
        m = _HF_EXPERT.match(name)
        if m is None:
            out[name] = t
        else:
            experts.setdefault(m.group(1), {}).setdefault(m.group(3), {})[int(m.group(2))] = t
    for prefix, parts in experts.items():
        n = len(parts["down"])
        out[prefix + ".gate_up_proj"] = torch.stack(
            [torch.cat([parts["gate"][e], parts["up"][e]]) for e in range(n)])
        out[prefix + ".down_proj"] = torch.stack([parts["down"][e] for e in range(n)])
    return out
