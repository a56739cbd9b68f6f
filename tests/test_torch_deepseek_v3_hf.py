"""The plain deepseek_v3 reference (``recformer_tpu_torch/reference/
deepseek_v3.py``) against Hugging Face ``transformers``' ``DeepseekV3Model``
loaded with the same tiny float32 weights: the published code ties the
reference's equations (latent attention with interleaved RoPE, the causal
mask, RMSNorm, the dense layer, the sigmoid router with its correction bias,
the routed and shared experts). Kept in a file of its own: importing
``transformers`` is slow, and neither the port nor the reference imports it.

Both run in float32 on the same inputs; they group their sums differently
(Hugging Face's attention is one matmul over the padded length, the
reference's blocks of the valid prefix), so they agree to 1e-4 of the
largest value, which a bf16 run would miss by far."""

import pytest
import torch

from test_torch_deepseek_v3 import TINY, make_batch, model_of, state, tiny

from recformer_tpu_torch.reference import deepseek_v3 as ref

transformers = pytest.importorskip("transformers")


def hf_model(cfg, own):
    from transformers import DeepseekV3Config, DeepseekV3Model

    hf_cfg = DeepseekV3Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        moe_intermediate_size=cfg.moe_intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_attention_heads, n_shared_experts=cfg.n_shared_experts,
        n_routed_experts=cfg.n_routed_experts, routed_scaling_factor=cfg.routed_scaling_factor,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=None,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        qk_nope_head_dim=cfg.qk_nope_head_dim, n_group=1, topk_group=1,
        num_experts_per_tok=cfg.num_experts_per_tok,
        first_k_dense_replace=cfg.first_k_dense_replace, norm_topk_prob=cfg.norm_topk_prob,
        hidden_act="silu", max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta, rope_interleave=True,
        attention_bias=False, pad_token_id=cfg.pad_token_id)
    hf_cfg._attn_implementation = "eager"
    model = DeepseekV3Model(hf_cfg).eval()
    sd = {}
    for name, t in own.items():
        bare = name[len("longformer."):]
        if bare.endswith("experts.gate_up_proj"):
            i = cfg.moe_intermediate_size
            for e in range(cfg.n_routed_experts):
                sd[bare.replace("gate_up_proj", f"{e}.gate_proj.weight")] = t[e, :i]
                sd[bare.replace("gate_up_proj", f"{e}.up_proj.weight")] = t[e, i:]
        elif bare.endswith("experts.down_proj"):
            for e in range(cfg.n_routed_experts):
                sd[bare.replace("down_proj", f"{e}.down_proj.weight")] = t[e]
        elif not bare.startswith(("token_type_embeddings", "item_position_embeddings")):
            sd[bare] = t
    model.load_state_dict(sd, strict=True)
    return model


def test_reference_matches_transformers_deepseek_v3():
    cfg = tiny()
    own = state(model_of(cfg))
    batch = make_batch(cfg, [64, 37, 12])
    want_h, want_p = ref.encode(own, cfg, batch)
    # Hugging Face's model takes RecFormer's summed embeddings as its input
    e = "longformer."
    embeds = (own[e + "embed_tokens.weight"][batch["input_ids"]]
              + own[e + "token_type_embeddings.weight"][batch["token_type_ids"]]
              + own[e + "item_position_embeddings.weight"][batch["item_position_ids"]])
    with torch.no_grad():
        out = hf_model(cfg, own)(inputs_embeds=embeds,
                                 attention_mask=batch["attention_mask"]).last_hidden_state
    valid = batch["attention_mask"].bool()[:, :, None]
    n = want_h.shape[1]
    err = (torch.where(valid[:, :n], out[:, :n] - want_h, 0).abs().max()
           / want_h.abs().max())
    assert float(err) < 1e-4
    last = batch["attention_mask"].sum(1) - 1
    torch.testing.assert_close(out[torch.arange(3), last], want_p, rtol=1e-4, atol=1e-4)
    assert TINY["num_hidden_layers"] == 3  # a dense layer and two routed ones
