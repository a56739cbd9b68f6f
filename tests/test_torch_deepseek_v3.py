"""The port's deepseek_v3 backbone (``models/deepseek_v3.py``, ``ops/moe.py``,
the causal form of ``ops/full_attention.py``) against its plain float32
reference (``recformer_tpu_torch/reference/deepseek_v3.py``) at a tiny size:
3 layers (layer 0 dense, 1-2 routed), hidden 64, 4 heads (q/k 16 + 8
rotated, v 16, latent 32), 8 experts of 24 (3 a token) plus 2 shared, rows
of up to 64 tokens with trailing padding, seeded random weights.

Tolerances: the port run in float32 follows the reference's equations with
other groupings of the same sums (a sorted dispatch, the fused attention's
blocks), so the two agree to float32 rounding, 1e-4 of the largest value;
the port run in bf16, the published precision, lies well above that (the
check that the comparison can tell the precisions apart)."""

import argparse

import pytest
import torch

from recformer_tpu_torch.cli.common import MODEL_SIZES, build_config
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.deepseek_v3 import rope_pairs, rope_tables
from recformer_tpu_torch.models.heads import (RecformerForFraudDetection,
                                              RecformerForPretraining, RecformerForSeqRec)
from recformer_tpu_torch.models.recformer import init_weights, last_token
from recformer_tpu_torch.ops import moe
from recformer_tpu_torch.ops.full_attention import full_attention_plain
from recformer_tpu_torch.reference import deepseek_v3 as ref
from recformer_tpu_torch.weights import deepseek_v3_from_hf

TINY = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=96, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3,
            moe_intermediate_size=24, max_token_num=64, item_seq_len=32,
            max_position_embeddings=64, attention_window=(16,) * 3, max_item_embeddings=11,
            pad_token_id=510, mask_token_id=511, bos_token_id=500, eos_token_id=501,
            sep_token_id=501, param_dtype="float32", dtype="float32", initializer_range=0.2)
TOL = 1e-4
BIAS_STD = 0.5  # e_score_correction_bias: large enough to change the choice


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(**kw):
    return RecformerConfig.moonlight_16b_a3b(**{**TINY, **kw})


def model_of(cfg, seed=0):
    m = RecformerForSeqRec(cfg)
    init_weights(m, cfg, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in m.named_buffers():
            if name.endswith("e_score_correction_bias"):
                b.normal_(0.0, BIAS_STD, generator=g)
    return m.eval()


def state(model):
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def make_batch(cfg, lens, L=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    B = len(lens)
    valid = torch.arange(L)[None, :] < torch.as_tensor(lens)[:, None]
    ids = torch.where(valid, torch.randint(4, 500, (B, L), generator=g), cfg.pad_token_id)
    ids[:, 0] = cfg.bos_token_id
    typ = torch.where(valid, torch.randint(1, 3, (B, L), generator=g), 3)
    typ[:, 0] = 0
    item = torch.where(valid, torch.randint(1, cfg.max_item_embeddings - 1, (B, L), generator=g),
                       cfg.max_item_embeddings - 1)
    item[:, 0] = 0
    glob = torch.zeros(B, L, dtype=torch.int64)
    glob[:, 0] = 1
    return {"input_ids": ids, "attention_mask": valid.long(), "global_attention_mask": glob,
            "token_type_ids": typ, "item_position_ids": item}


def gap(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("layers", [1, 3], ids=["dense_layer_0", "dense_and_moe"])
def test_forward_matches_reference(layers):
    cfg = tiny(num_hidden_layers=layers, attention_window=(16,) * layers)
    model = model_of(cfg)
    batch = make_batch(cfg, [64, 40, 1, 23])
    with torch.no_grad():
        hidden, pooled = model.longformer.forward_eager(
            batch["input_ids"], batch["attention_mask"], batch["global_attention_mask"],
            batch["token_type_ids"], batch["item_position_ids"])
    want_h, want_p = ref.encode(state(model), cfg, batch)
    n = want_h.shape[1]
    valid = batch["attention_mask"][:, :n, None].bool()
    assert gap(torch.where(valid, hidden[:, :n], 0), want_h * valid) < TOL
    assert gap(pooled, want_p) < TOL
    # the pooled state is the last valid token's, read through the serving path
    with torch.no_grad():
        assert torch.equal(model(batch), pooled)
    assert torch.equal(pooled[2], hidden[2, 0])


def test_bf16_forward_lies_outside_the_tolerance():
    cfg = tiny(dtype="bfloat16")
    model = model_of(cfg)
    batch = make_batch(cfg, [64, 40])
    with torch.no_grad():
        pooled = model(batch)
    _, want = ref.encode(state(model), cfg, batch)
    assert gap(pooled, want) > 10 * TOL


def test_padding_keys_leave_valid_rows_unchanged():
    cfg = tiny()
    model = model_of(cfg)
    batch = make_batch(cfg, [30, 30])
    other = {k: v.clone() for k, v in batch.items()}
    other["input_ids"][:, 30:] = 7  # what padding holds is never read
    with torch.no_grad():
        h1 = model.longformer.forward_eager(*(batch[k] for k in (
            "input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
            "item_position_ids")))[0]
        h2 = model.longformer.forward_eager(*(other[k] for k in (
            "input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
            "item_position_ids")))[0]
    assert torch.equal(h1[:, :30], h2[:, :30])


def test_moe_matches_the_expert_loop_and_the_bias_moves_only_the_choice():
    cfg = tiny()
    model = model_of(cfg)
    layer = model.longformer.layers[1].mlp
    x = torch.randn(50, cfg.hidden_size, generator=torch.Generator().manual_seed(3))
    W = {k[len("longformer.layers.1."):]: v for k, v in state(model).items()
         if k.startswith("longformer.layers.1.")}
    want = ref.moe(W, cfg, x, ref.Numerics())
    with torch.no_grad():
        got = layer(x[None], torch.ones(1, 50, dtype=torch.long))[0]
    assert gap(got, want) < TOL
    # the bias changes which experts are chosen ...
    bias = W["mlp.gate.e_score_correction_bias"]
    s = torch.sigmoid(x @ W["mlp.gate.weight"].t())
    with_bias = torch.topk(s + bias, cfg.num_experts_per_tok).indices.sort(-1).values
    without = torch.topk(s, cfg.num_experts_per_tok).indices.sort(-1).values
    assert (with_bias != without).any(-1).float().mean() > 0.2
    # ... and a weighting by the biased scores would fail the comparison
    experts, _ = ref.route(W, cfg, x)
    w = (s + bias).gather(1, experts)
    w = w / w.sum(-1, keepdim=True) * cfg.routed_scaling_factor
    with torch.no_grad():
        wrong = moe.routed_experts(x, torch.ones(50, dtype=torch.bool), experts, w,
                                   W["mlp.experts.gate_up_proj"], W["mlp.experts.down_proj"])
        wrong = wrong + layer.shared_experts(x)
    assert gap(wrong, want) > 100 * TOL


def test_expert_offsets_on_uneven_loads():
    E = 6
    # expert 0: 5 rows, 1: none, 2: 1, 3: 7, 4: none, 5: 2; 3 rows left out (id E)
    ids = torch.tensor([3, 0, 3, 6, 5, 3, 0, 2, 3, 0, 6, 3, 0, 5, 3, 0, 3, 6])
    order, offs = moe.expert_offsets(ids, E)
    assert offs.dtype == torch.int32
    assert offs.tolist() == [5, 5, 6, 13, 13, 15]
    assert ids[order].tolist() == sorted(ids.tolist())
    # stable: rows of one expert keep their order
    assert order[:5].tolist() == [1, 6, 9, 12, 15]
    g = torch.Generator().manual_seed(0)
    a = torch.randn(len(ids), 8, generator=g)
    b = torch.randn(E, 8, 5, generator=g)
    out = moe.grouped_mm_plain(a[order], b, offs)
    want = torch.stack([a[i] @ b[ids[i]] if ids[i] < E else torch.zeros(5)
                        for i in order.tolist()])
    torch.testing.assert_close(out, want)


def test_padding_rows_are_left_out_of_the_experts():
    cfg = tiny()
    layer = model_of(cfg).longformer.layers[2].mlp
    x = torch.randn(2, 20, cfg.hidden_size, generator=torch.Generator().manual_seed(5))
    mask = torch.ones(2, 20, dtype=torch.long)
    mask[1, 12:] = 0
    with torch.no_grad():
        full = layer(x, torch.ones_like(mask))
        part = layer(x, mask)
    # the same rows through other group sizes: equal to float32 rounding
    torch.testing.assert_close(part[0], full[0])
    torch.testing.assert_close(part[1, :12], full[1, :12])
    # a padding token gets the shared experts alone
    torch.testing.assert_close(part[1, 12:], layer.shared_experts(x[1:, 12:])[0])


def test_causal_attention_and_interleaved_rope():
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 9, 3, 12, generator=g), torch.randn(2, 9, 3, 12, generator=g)
    v = torch.randn(2, 9, 3, 5, generator=g)
    mask = torch.ones(2, 9, dtype=torch.long)
    out = full_attention_plain(q, k, v, mask, causal=True)
    for i in range(9):
        s = torch.einsum("bhd,bmhd->bhm", q[:, i], k[:, :i + 1]) / 12 ** 0.5
        want = torch.einsum("bhm,bmhd->bhd", s.softmax(-1), v[:, :i + 1])
        torch.testing.assert_close(out[:, i], want, rtol=1e-5, atol=1e-6)
    # rotating adjacent pairs in place and rotate_half over the de-interleaved
    # layout give the same scores
    cos, sin = rope_tables(9, 12, 50000.0, "cpu", torch.float32)
    qr, kr = rope_pairs(q, cos, sin), rope_pairs(k, cos, sin)
    c2, s2 = ref.rope(9, 12, 50000.0, "cpu")
    torch.testing.assert_close(qr, ref.rotate(q, c2, s2))
    p = torch.arange(9, dtype=torch.float32)[:, None] / 50000.0 ** (torch.arange(0, 12, 2) / 12)
    qc = torch.view_as_complex(q.reshape(2, 9, 3, 6, 2).contiguous()) * torch.polar(
        torch.ones_like(p), p)[None, :, None]
    kc = torch.view_as_complex(k.reshape(2, 9, 3, 6, 2).contiguous()) * torch.polar(
        torch.ones_like(p), p)[None, :, None]
    torch.testing.assert_close(torch.einsum("blhd,bmhd->bhlm", qr, kr),
                               torch.einsum("blhd,bmhd->bhlm", torch.view_as_real(qc).flatten(-2),
                                            torch.view_as_real(kc).flatten(-2)),
                               rtol=1e-4, atol=1e-4)


def test_last_token_pooling():
    h = torch.randn(3, 5, 4)
    mask = torch.tensor([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [0, 0, 0, 0, 0]])
    torch.testing.assert_close(last_token(h, mask), torch.stack([h[0, 4], h[1, 1], h[2, 0]]))


def test_recipe_count_and_refusals():
    cfg = RecformerConfig.moonlight_16b_a3b()
    assert (cfg.backbone, cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size,
            cfg.qk_head_dim, cfg.param_dtype, cfg.pooler_type, cfg.max_token_num) == (
        "deepseek_v3", 27, 2048, 163840, 192, "bfloat16", "last", 8192)
    with torch.device("meta"):
        m = RecformerForSeqRec(cfg)
    n = sum(p.numel() for p in m.parameters()) + sum(b.numel() for b in m.buffers())
    assert n == 15_625_190_528
    assert sum(isinstance(lyr.mlp, type(m.longformer.layers[1].mlp))
               for lyr in m.longformer.layers) == 26
    for bad in (dict(q_lora_rank=1536), dict(n_group=8), dict(topk_group=4),
                dict(attention_head_shard_axis="model"), dict(hidden_dropout_prob=0.1),
                dict(pooler_type="cls"), dict(remat=True), dict(max_token_num=16384),
                dict(attention_impl="sequence_parallel"), dict(hidden_act="gelu")):
        with pytest.raises(ValueError):
            RecformerConfig.moonlight_16b_a3b(**bad)
    small = tiny()
    for head in (RecformerForPretraining, RecformerForFraudDetection):
        with pytest.raises(ValueError, match="inference only"):
            head(small)
    assert RecformerConfig.from_json(cfg.to_json()) == cfg
    args = argparse.Namespace(model_size="moonlight-16b-a3b")
    assert build_config(args) == cfg and "moonlight-16b-a3b" in MODEL_SIZES
    assert cfg.inference_only and not RecformerConfig.base().inference_only
    assert "global_rope_theta" not in cfg.to_json()
    assert "kv_lora_rank" not in RecformerConfig.base().to_json()


def test_hf_names_load_onto_the_stacked_experts():
    cfg = tiny()
    model = model_of(cfg)
    own = state(model)
    hf = {}
    for name, t in own.items():
        bare = "model." + name[len("longformer."):]
        if name.endswith("experts.gate_up_proj"):
            for e in range(cfg.n_routed_experts):
                i = cfg.moe_intermediate_size
                hf[bare[:-len("gate_up_proj")] + f"{e}.gate_proj.weight"] = t[e, :i]
                hf[bare[:-len("gate_up_proj")] + f"{e}.up_proj.weight"] = t[e, i:]
        elif name.endswith("experts.down_proj"):
            for e in range(cfg.n_routed_experts):
                hf[bare[:-len("down_proj")] + f"{e}.down_proj.weight"] = t[e]
        else:
            hf[bare] = t
    hf["lm_head.weight"] = torch.zeros(cfg.vocab_size, cfg.hidden_size)
    back = deepseek_v3_from_hf(hf)
    assert back.keys() == own.keys()
    assert all(torch.equal(back[k], own[k]) for k in own)
