"""Single-source-of-truth configuration, PyTorch side.

Same fields, defaults, validation, recipes and JSON as
``recformer_tpu/config.py``, so one config file drives both packages. Only
the dtype properties differ: they return ``torch.dtype``s.

Knobs that only shape the JAX program keep their names and are accepted
here without changing the forward math: ``scan_layers``/``scan_unroll`` run
the same plain layer loop, ``remat``/``remat_policy`` only matter for a
backward pass. ``embed_ln_impl='pallas'`` sums the four embedding lookups
in float32 and LayerNorms them through the fused embedding kernels
(``ops/embed_layernorm.py``; ``'xla'`` sums in the compute type, plainly).
``ln_impl`` selects the encoder blocks' LayerNorm: ``'xla'`` flax's fast
variance, ``'pallas_bwd'`` the two-pass forward with the LayerNorm backward
kernel (``ops/layernorm.py``), ``'split_bwd'`` the same forward with a plain
backward; the LM head keeps flax's under every value. ``attention_impl``
keeps its values:
``'pallas'`` selects the hand-written windowed-attention kernel (its plain
version on the CPU), ``'dense'`` and ``'chunked'`` the plain twins, and
``'sequence_parallel'`` is refused: sequence parallelism is not ported yet.
``attention_head_shard_axis`` marks a tensor-parallel model, whose heads
``parallel/tensor.py`` shards over the ``model`` process group.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class RecformerConfig:
    """Model + data-contract hyperparameters (see the JAX package's
    ``RecformerConfig`` for the meaning of each field)."""

    # --- text/backbone (longformer-base-4096 geometry) ---
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 4098
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02

    # --- special token ids (RoBERTa/Longformer conventions) ---
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    sep_token_id: int = 2
    mask_token_id: int = 50264

    # --- attention ---
    attention_window: Tuple[int, ...] = (64,) * 12
    attention_impl: str = "chunked"
    sequence_axis: str = "seq"
    attention_head_shard_axis: str | None = None
    embed_ln_impl: str = "xla"
    ln_impl: str = "xla"
    global_kv_mode: str = "thin"

    # --- rec-specific data contract ---
    token_type_size: int = 4
    max_token_num: int = 1024
    max_item_embeddings: int = 51
    max_attr_num: int = 3
    max_attr_length: int = 32

    # --- heads / losses ---
    pooler_type: str = "cls"  # 'cls' | 'avg'
    temp: float = 0.05
    mlm_weight: float = 0.1
    mlm_probability: float = 0.15
    item_num: int = 0
    finetune_negative_sample_size: int = 0
    pos_weight: float = 1.0

    # --- execution ---
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    item_seq_len: int = 128
    fuse_mlm_pass: bool = True
    scan_layers: bool = False
    remat: bool = False
    remat_policy: str = "full"
    scan_unroll: int = 1
    contrastive_gradient: str = "full"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if isinstance(self.attention_window, int):
            object.__setattr__(
                self,
                "attention_window",
                (self.attention_window,) * self.num_hidden_layers,
            )
        else:
            object.__setattr__(self, "attention_window", tuple(self.attention_window))
        if len(self.attention_window) != self.num_hidden_layers:
            raise ValueError(
                f"len(attention_window)={len(self.attention_window)} must equal "
                f"num_hidden_layers={self.num_hidden_layers}"
            )
        for w in self.attention_window:
            if w <= 0 or w % 2:
                raise ValueError(f"attention_window entries must be positive and even, got {w}")
        if self.max_token_num % max(self.attention_window):
            raise ValueError(
                "max_token_num must be a multiple of the largest attention window "
                f"({self.max_token_num} % {max(self.attention_window)} != 0)"
            )
        if self.item_seq_len % max(self.attention_window):
            raise ValueError("item_seq_len must be a multiple of the largest attention window")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must be divisible by num_attention_heads")
        if self.max_token_num + self.pad_token_id + 1 > self.max_position_embeddings:
            raise ValueError(
                f"max_token_num={self.max_token_num} needs at least "
                f"{self.max_token_num + self.pad_token_id + 1} position embeddings, "
                f"got {self.max_position_embeddings}"
            )
        if self.hidden_act not in ("gelu", "gelu_tanh", "relu"):
            raise ValueError(f"unknown hidden_act {self.hidden_act!r}")
        if self.remat_policy not in ("full", "save_attention", "dots", "dots_attn"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.scan_unroll < 1 or (self.scan_layers and
                                    self.num_hidden_layers % self.scan_unroll):
            raise ValueError("scan_unroll must be >=1 and divide num_hidden_layers")
        if self.pooler_type not in ("cls", "avg"):
            raise ValueError(f"unknown pooler_type {self.pooler_type!r}")
        if self.attention_impl not in ("dense", "chunked", "pallas",
                                       "sequence_parallel"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.embed_ln_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown embed_ln_impl {self.embed_ln_impl!r}")
        if self.ln_impl not in ("xla", "pallas_bwd", "split_bwd"):
            raise ValueError(f"unknown ln_impl {self.ln_impl!r}")
        if self.global_kv_mode not in ("thin", "full"):
            raise ValueError(f"unknown global_kv_mode {self.global_kv_mode!r}")
        if self.scan_layers and len(set(self.attention_window)) != 1:
            raise ValueError("scan_layers requires all attention windows equal")
        if self.contrastive_gradient not in ("full", "local"):
            raise ValueError(f"unknown contrastive_gradient {self.contrastive_gradient!r}")

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def max_item_token_len(self) -> int:
        """Max tokens a single encoded item can contribute."""
        return self.max_attr_num * self.max_attr_length

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "RecformerConfig":
        return dataclasses.replace(self, **kw)

    # --- canonical recipes -------------------------------------------
    @classmethod
    def base(cls, **kw) -> "RecformerConfig":
        """The canonical recipe: longformer-base backbone, window 64, 1024
        tokens, 51 item positions, 3x32 attributes, the fused windowed
        attention kernel and the tanh GELU."""
        kw.setdefault("attention_impl", "pallas")
        kw.setdefault("hidden_act", "gelu_tanh")
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "RecformerConfig":
        """Small config for tests and CI: 2 layers, hidden 64, window 16."""
        defaults = dict(
            vocab_size=1024,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=520,
            attention_window=(16, 16),
            max_token_num=256,
            max_item_embeddings=11,
            max_attr_num=3,
            max_attr_length=8,
            item_seq_len=32,
            mask_token_id=1023,
        )
        defaults.update(kw)
        return cls(**defaults)

    # --- (de)serialization -------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RecformerConfig":
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "RecformerConfig":
        with open(path) as f:
            return cls.from_json(f.read())
