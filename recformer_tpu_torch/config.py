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
``'sequence_parallel'`` the sequence-parallel op (``parallel/sequence.py``),
which runs inside that module's entry points.
``attention_head_shard_axis`` marks a tensor-parallel model, whose heads
``parallel/tensor.py`` shards over the ``model`` process group.

``backbone`` selects the encoder: ``'longformer'`` (the post-LayerNorm
Longformer block of the JAX package) or ``'modernbert'`` (ModernBERT's
pre-LayerNorm block, ``models/modernbert.py``, which the JAX package does
not have). The ModernBERT fields keep ModernBERT's config keys: every
``global_attn_every_n_layers``-th layer, from layer 0, attends to every
non-padding token with RoPE at ``global_rope_theta``; the others attend to
the tokens within ``local_attention // 2`` with RoPE at
``local_rope_theta``. Its LayerNorms and projections carry no bias and its
tied MLM decoder does, as ModernBERT publishes them (``norm_bias``,
``attention_bias``, ``mlp_bias`` and ``classifier_bias`` false,
``decoder_bias`` true); the MLP is GeGLU, ``Wi`` of width
``2 * intermediate_size``. Token positions enter only through RoPE, so
``max_position_embeddings`` bounds ``max_token_num`` and no position table
exists. Such a model runs on one device (no tensor, sequence or pipeline
parallelism) and without dropout, as ModernBERT publishes it.

``backbone='deepseek_v3'`` is the DeepSeek-V3 decoder block
(``models/deepseek_v3.py``; Moonlight-16B-A3B's settings are
:meth:`RecformerConfig.moonlight_16b_a3b`), its fields named by Hugging
Face's ``DeepseekV3Config`` keys: latent attention (``kv_lora_rank``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``; ``q_lora_rank``
must be None), causal, RoPE at ``rope_theta`` over adjacent pairs;
RMSNorm at ``rms_norm_eps``; the first ``first_k_dense_replace`` layers a
SwiGLU MLP of width ``intermediate_size``, the others ``n_routed_experts``
sigmoid-routed SwiGLU experts of width ``moe_intermediate_size``
(``num_experts_per_tok`` a token, weights normalised when
``norm_topk_prob``, times ``routed_scaling_factor``; ``n_group`` and
``topk_group`` must be 1) plus ``n_shared_experts`` shared ones. It pools
the last valid token (``pooler_type='last'``), reads no
``attention_window``, and runs for inference only: on one device, without
dropout, and without the pretraining and fraud heads
(:attr:`RecformerConfig.inference_only`, which the heads and the CLI that
train read).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple

import torch


# the backbone selector and the fields only the modernbert backbone reads
MODERNBERT_FIELDS = ("backbone", "global_attn_every_n_layers", "local_attention",
                     "global_rope_theta", "local_rope_theta")
# the fields only the deepseek_v3 backbone reads
DEEPSEEK_V3_FIELDS = ("kv_lora_rank", "q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                      "v_head_dim", "n_routed_experts", "n_shared_experts",
                      "num_experts_per_tok", "moe_intermediate_size", "first_k_dense_replace",
                      "routed_scaling_factor", "norm_topk_prob", "n_group", "topk_group",
                      "rope_theta", "rms_norm_eps")
BACKBONES = ("longformer", "modernbert", "deepseek_v3")


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
    pooler_type: str = "cls"  # 'cls' | 'avg'; 'last' (deepseek_v3 only)
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

    # --- backbone (ModernBERT's keys; read when backbone='modernbert') ---
    backbone: str = "longformer"
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0

    # --- backbone (DeepSeek-V3's keys; read when backbone='deepseek_v3') ---
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5

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
        if self.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {self.backbone!r}")
        if self.backbone == "modernbert":
            self._check_modernbert()
        elif self.backbone == "deepseek_v3":
            self._check_deepseek_v3()
        elif self.max_token_num + self.pad_token_id + 1 > self.max_position_embeddings:
            raise ValueError(
                f"max_token_num={self.max_token_num} needs at least "
                f"{self.max_token_num + self.pad_token_id + 1} position embeddings, "
                f"got {self.max_position_embeddings}"
            )
        if self.backbone != "deepseek_v3" and self.hidden_act not in ("gelu", "gelu_tanh",
                                                                       "relu"):
            raise ValueError(f"unknown hidden_act {self.hidden_act!r}")
        if self.remat_policy not in ("full", "save_attention", "dots", "dots_attn"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.scan_unroll < 1 or (self.scan_layers and
                                    self.num_hidden_layers % self.scan_unroll):
            raise ValueError("scan_unroll must be >=1 and divide num_hidden_layers")
        if self.pooler_type not in (("last",) if self.backbone == "deepseek_v3"
                                    else ("cls", "avg")):
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

    def _check_modernbert(self):
        if self.global_attn_every_n_layers < 1:
            raise ValueError("global_attn_every_n_layers must be >= 1")
        if self.attention_window != (self.local_attention,) * self.num_hidden_layers:
            raise ValueError("a modernbert backbone's attention_window is local_attention on "
                             f"every layer, got {self.attention_window}")
        if max(self.max_token_num, self.item_seq_len) > self.max_position_embeddings:
            raise ValueError(f"max_token_num={self.max_token_num} exceeds "
                             f"max_position_embeddings={self.max_position_embeddings}")
        if self.attention_head_shard_axis is not None:
            raise ValueError("the modernbert backbone does not run under tensor parallelism")
        if self.attention_impl == "sequence_parallel":
            raise ValueError("the modernbert backbone does not run under sequence parallelism")
        if self.hidden_dropout_prob or self.attention_probs_dropout_prob:
            raise ValueError("the modernbert backbone runs without dropout (ModernBERT's "
                             "published dropouts are 0)")
        if self.embed_ln_impl != "xla" or self.ln_impl != "xla":
            raise ValueError("the modernbert backbone takes embed_ln_impl='xla', ln_impl='xla'")
        if self.pooler_type != "cls":
            raise ValueError("the modernbert backbone pools the first token (pooler_type='cls')")

    def _check_deepseek_v3(self):
        if self.q_lora_rank is not None:
            raise ValueError("the deepseek_v3 backbone takes q_lora_rank=None (q_proj alone)")
        if self.n_group != 1 or self.topk_group != 1:
            raise ValueError("the deepseek_v3 backbone routes over one group "
                             "(n_group = topk_group = 1)")
        if not 0 <= self.first_k_dense_replace <= self.num_hidden_layers:
            raise ValueError("first_k_dense_replace must lie in [0, num_hidden_layers]")
        if not 1 <= self.num_experts_per_tok <= self.n_routed_experts:
            raise ValueError("num_experts_per_tok must lie in [1, n_routed_experts]")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even (RoPE rotates pairs)")
        if max(self.max_token_num, self.item_seq_len) > self.max_position_embeddings:
            raise ValueError(f"max_token_num={self.max_token_num} exceeds "
                             f"max_position_embeddings={self.max_position_embeddings}")
        if self.attention_head_shard_axis is not None:
            raise ValueError("the deepseek_v3 backbone does not run under tensor parallelism")
        if self.attention_impl == "sequence_parallel":
            raise ValueError("the deepseek_v3 backbone does not run under sequence parallelism")
        if self.scan_layers or self.remat:
            raise ValueError("the deepseek_v3 backbone runs for inference only "
                             "(no scan_layers, no remat)")
        if self.hidden_dropout_prob or self.attention_probs_dropout_prob:
            raise ValueError("the deepseek_v3 backbone runs without dropout")
        if self.hidden_act != "silu":
            raise ValueError("the deepseek_v3 backbone's MLPs are SwiGLU (hidden_act='silu')")

    @property
    def qk_head_dim(self) -> int:
        """A deepseek_v3 head's query and key width: the part without RoPE
        and the rotated part."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def inference_only(self) -> bool:
        """Whether the backbone runs for inference only (deepseek_v3): the
        heads and the CLI that train refuse such a config."""
        return self.backbone == "deepseek_v3"

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i`` of a deepseek_v3 backbone routes to experts."""
        return i >= self.first_k_dense_replace

    def is_global_layer(self, i: int) -> bool:
        """Whether layer ``i`` of a modernbert backbone attends globally."""
        return i % self.global_attn_every_n_layers == 0

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
    def modernbert_large(cls, **kw) -> "RecformerConfig":
        """ModernBERT-large (answerdotai/ModernBERT-large's config.json) as
        RecFormer's backbone: 28 pre-LayerNorm layers, hidden 1,024, 16 heads
        of 64, GeGLU 2 x 2,624, layers 0, 3, ..., 27 global (RoPE theta
        160,000), the rest within 64 tokens (RoPE theta 10,000), no bias but
        the decoder's, dropout 0, vocabulary 50,368, 8,192 positions. The
        RecFormer contract stays: 4 token types, item positions (301, for
        histories of up to 300 items), 3 x 32 attribute tokens, 128-token
        items, CLS pooling; histories of 8,192 tokens."""
        defaults = dict(
            backbone="modernbert",
            vocab_size=50368,
            hidden_size=1024,
            num_hidden_layers=28,
            num_attention_heads=16,
            intermediate_size=2624,
            hidden_act="gelu",
            hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0,
            max_position_embeddings=8192,
            layer_norm_eps=1e-5,
            initializer_range=0.02,
            pad_token_id=50283,
            bos_token_id=50281,
            eos_token_id=50282,
            sep_token_id=50282,
            mask_token_id=50284,
            attention_window=(128,) * 28,
            attention_impl="pallas",
            global_attn_every_n_layers=3,
            local_attention=128,
            global_rope_theta=160000.0,
            local_rope_theta=10000.0,
            max_token_num=8192,
            max_item_embeddings=301,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def moonlight_16b_a3b(cls, **kw) -> "RecformerConfig":
        """Moonlight-16B-A3B (moonshotai/Moonlight-16B-A3B's config.json,
        ``model_type`` deepseek_v3) as RecFormer's user encoder: 27 pre-RMSNorm
        causal layers, hidden 2,048, 16 latent-attention heads (q 128 + 64
        rotated, latent 512, v 128), layer 0 a SwiGLU MLP of 11,264, layers
        1-26 64 sigmoid-routed experts of 1,408 (6 a token, scale 2.446)
        plus 2 shared, vocabulary 163,840, 8,192 positions, RoPE theta
        50,000. Weights and compute in bf16, as published. The RecFormer
        contract stays: 4 token types, item positions (301, for histories of
        up to 300 items), 3 x 32 attribute tokens, 128-token items; the
        pooled output is the last valid token's state. Special ids: Moonlight's
        ``[BOS]`` 163,584 and ``[EOS]`` 163,585; pad and mask at the top of
        the vocabulary (assumed)."""
        defaults = dict(
            backbone="deepseek_v3",
            vocab_size=163840,
            hidden_size=2048,
            num_hidden_layers=27,
            num_attention_heads=16,
            intermediate_size=11264,
            hidden_act="silu",
            hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0,
            max_position_embeddings=8192,
            initializer_range=0.02,
            pad_token_id=163838,
            bos_token_id=163584,
            eos_token_id=163585,
            sep_token_id=163585,
            mask_token_id=163839,
            attention_window=(128,) * 27,
            attention_impl="pallas",
            max_token_num=8192,
            max_item_embeddings=301,
            item_seq_len=128,
            pooler_type="last",
            param_dtype="bfloat16",
            kv_lora_rank=512,
            q_lora_rank=None,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            n_routed_experts=64,
            n_shared_experts=2,
            num_experts_per_tok=6,
            moe_intermediate_size=1408,
            first_k_dense_replace=1,
            routed_scaling_factor=2.446,
            norm_topk_prob=True,
            n_group=1,
            topk_group=1,
            rope_theta=50000.0,
            rms_norm_eps=1e-5,
        )
        defaults.update(kw)
        return cls(**defaults)

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
        """The fields as JSON; a config leaves out the fields of the
        backbones it is not (it reads none of them), so a longformer
        config's JSON is the JAX package's."""
        doc = dataclasses.asdict(self)
        drop = {"longformer": MODERNBERT_FIELDS + DEEPSEEK_V3_FIELDS,
                "modernbert": DEEPSEEK_V3_FIELDS,
                "deepseek_v3": MODERNBERT_FIELDS[1:]}[self.backbone]
        for name in drop:
            del doc[name]
        return json.dumps(doc, indent=2, sort_keys=True)

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
