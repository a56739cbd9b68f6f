"""The port's ModernBERT backbone (``models/modernbert.py``) against its plain
float32 reference (``recformer_tpu_torch/reference/modernbert.py``) at a tiny
size: 3 layers (layer 0 global, 1-2 local), hidden 64, 4 heads,
``local_attention`` 16, rows of up to 128 tokens, seeded random weights."""

import argparse
import math

import pytest
import torch

from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForPretraining, RecformerForSeqRec
from recformer_tpu_torch.models.modernbert import ModernBertModel, rope_tables
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.ops.full_attention import full_attention_plain
from recformer_tpu_torch.ops.window_attention import (band_attention_bwd,
                                                      local_window_attention,
                                                      window_attention_plain)
from recformer_tpu_torch.reference import modernbert as ref
from recformer_tpu_torch.training.steps import pretrain_loss

TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=128, attention_window=(16,) * 3,
            local_attention=16, max_token_num=128, max_item_embeddings=11, item_seq_len=32,
            pad_token_id=1, bos_token_id=0, eos_token_id=2, sep_token_id=2, mask_token_id=1023,
            dtype="float32", attention_impl="pallas", initializer_range=0.2)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(**kw):
    return RecformerConfig.modernbert_large(**{**TINY, **kw})


def model_of(cls, cfg, seed=0, bias=False):
    torch.manual_seed(seed)
    m = cls(cfg)
    init_weights(m, cfg, torch.Generator().manual_seed(seed))
    if bias:  # the decoder's bias, exercised
        with torch.no_grad():
            for n, p in m.named_parameters():
                if n.endswith("bias"):
                    p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(len(n)))
    return m.eval()


def params(model):
    return {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}


def make_batch(cfg, B, L, seed, lens=None):
    g = torch.Generator().manual_seed(seed)
    lens = lens if lens is not None else torch.randint(L // 3, L + 1, (B,), generator=g)
    valid = torch.arange(L)[None, :] < torch.as_tensor(lens)[:, None]
    ids = torch.randint(4, cfg.vocab_size - 1, (B, L), generator=g)
    ids[:, 0] = cfg.bos_token_id
    ids = torch.where(valid, ids, cfg.pad_token_id)
    typ = torch.where(valid, torch.randint(1, 3, (B, L), generator=g), 3)
    typ[:, 0] = 0
    item = torch.where(valid, torch.randint(1, cfg.max_item_embeddings - 1, (B, L), generator=g),
                       cfg.max_item_embeddings - 1)
    item[:, 0] = 0
    glob = torch.zeros(B, L, dtype=torch.int64)
    glob[:, 0] = 1
    return {"input_ids": ids, "attention_mask": valid.long(), "global_attention_mask": glob,
            "token_type_ids": typ, "item_position_ids": item}


def forward(model, batch):
    return model.longformer(batch["input_ids"], batch["attention_mask"],
                            batch["global_attention_mask"], batch["token_type_ids"],
                            batch["item_position_ids"])


@pytest.mark.parametrize("impl", ["pallas", "dense"])
def test_forward_matches_reference(impl):
    cfg = tiny(attention_impl=impl)
    model = model_of(RecformerForSeqRec, cfg, bias=True)
    batch = make_batch(cfg, 3, 128, seed=1, lens=[128, 77, 9])
    with torch.no_grad():
        hidden, pooled = forward(model, batch)
        want = ref.encode(params(model), cfg, batch, batch["input_ids"])
    valid = batch["attention_mask"].bool()
    torch.testing.assert_close(hidden[valid], want[valid], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pooled, want[:, 0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(model(batch), want[:, 0], rtol=1e-5, atol=1e-5)


def _views(cfg, B, seed):
    """Two pretraining views (history rows at 128, item rows at 32) with
    six masked tokens a row: the program's batches and the reference's
    (batch, corrupted ids, masked) triples."""
    out, ref_views = [], []
    for k, L in enumerate((128, cfg.item_seq_len)):
        b = make_batch(cfg, B, L, seed + k, lens=[L - 3 * i for i in range(B)])
        g = torch.Generator().manual_seed(seed + 10 + k)
        pos = torch.stack([1 + torch.randperm(int(n) - 1, generator=g)[:6]
                           for n in b["attention_mask"].sum(1)])
        masked = torch.zeros_like(b["attention_mask"], dtype=torch.bool)
        masked.scatter_(1, pos, True)
        corrupted = torch.where(masked, cfg.mask_token_id, b["input_ids"])
        out.append(dict(b, mlm_input_ids=corrupted, mlm_positions=pos,
                        mlm_labels=torch.gather(b["input_ids"], 1, pos)))
        ref_views.append((b, corrupted, masked))
    return out, ref_views


@pytest.mark.parametrize("remat", [False, True])
def test_pretraining_loss_and_every_gradient_match_reference(remat):
    cfg = tiny(remat=remat)
    model = model_of(RecformerForPretraining, cfg, bias=True).train()
    (a, b), ref_views = _views(cfg, 3, seed=5)
    loss, _ = pretrain_loss(cfg, model(a, b), a, b)
    loss.backward()
    P = params(model)
    want = ref.pretrain_loss(P, cfg, ref_views)
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-4, atol=0.0)
    assert len(P) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        scale = P[name].grad.abs().max()
        torch.testing.assert_close(p.grad, P[name].grad, rtol=1e-4, atol=1e-4 * scale,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("L, window", [(128, 16), (96, 32)])
def test_band_without_globals_matches_dense_masked_softmax(L, window):
    g = torch.Generator().manual_seed(L + window)
    B, H, D = 2, 4, 16
    q, k, v = (torch.randn(B, L, H, D, generator=g, requires_grad=True) for _ in range(3))
    mask = (torch.arange(L)[None, :] < torch.tensor([[L], [L // 2 + 3]])).long()
    out = local_window_attention(q, k, v, mask, window)
    near = (torch.arange(L)[:, None] - torch.arange(L)[None, :]).abs() <= window // 2
    want = full_attention_plain(q, k, v, (mask != 0)[:, None, :] & near[None])
    valid = mask.bool()
    torch.testing.assert_close(out[valid], want[valid], rtol=1e-5, atol=1e-5)
    assert not out[~valid].any()  # padding rows give 0
    dout = torch.randn(out.shape, generator=g) * valid[:, :, None, None]
    grads = torch.autograd.grad(out, (q, k, v), dout)
    want_grads = torch.autograd.grad(want, (q, k, v), dout)
    for got, w in zip(grads, want_grads):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)


def test_band_plain_versions_take_no_global_column():
    g = torch.Generator().manual_seed(3)
    B, L, H, D, W = 1, 64, 2, 8, 16
    q2, k2, v2, dout = (torch.randn(B, L, H * D, generator=g) for _ in range(4))
    keyloc = torch.ones(B, L, dtype=torch.int32)
    none = q2.new_zeros((B, 0, H * D))
    out = window_attention_plain(q2, k2, v2, keyloc, none, none, keyloc[:, :0], keyloc, none,
                                 H, W, True)
    grads = band_attention_bwd(q2, k2, v2, keyloc, none, none, keyloc[:, :0], keyloc, none,
                               dout, H, W, True)
    assert out.shape == q2.shape and torch.isfinite(out).all()
    assert [tuple(t.shape) for t in grads[3:]] == [(B, 0, H * D)] * 3


def test_padded_keys_leave_valid_rows_unchanged():
    cfg = tiny()
    assert [cfg.is_global_layer(i) for i in range(3)] == [True, False, False]
    model = model_of(RecformerForSeqRec, cfg)
    batch = make_batch(cfg, 2, 128, seed=9, lens=[100, 40])
    junk = dict(batch)
    pad = batch["attention_mask"] == 0
    g = torch.Generator().manual_seed(11)
    junk["input_ids"] = torch.where(pad, torch.randint(4, 1000, pad.shape, generator=g),
                                    batch["input_ids"])
    junk["token_type_ids"] = torch.where(pad, 1, batch["token_type_ids"])
    with torch.no_grad():
        h0, _ = forward(model, batch)
        h1, _ = forward(model, junk)
    valid = ~pad
    torch.testing.assert_close(h0[valid], h1[valid], rtol=0, atol=1e-6)
    # each layer kind alone: keys and values of padding altered
    x = torch.randn(2, 128, 4, 16, generator=g)
    y = torch.where(pad[:, :, None, None], torch.randn(x.shape, generator=g), x)
    for op in (lambda t: full_attention_plain(t, t, t, batch["attention_mask"]),
               lambda t: local_window_attention(t, t, t, batch["attention_mask"], 16)):
        torch.testing.assert_close(op(x)[valid], op(y)[valid], rtol=0, atol=1e-6)


def test_each_layer_kind_takes_its_own_theta():
    cfg = tiny(global_rope_theta=160000.0, local_rope_theta=10.0)
    model = model_of(RecformerForSeqRec, cfg)
    bb = model.longformer
    assert isinstance(bb, ModernBertModel)
    for is_global, theta in ((True, 160000.0), (False, 10.0)):
        got = bb.rope(128, is_global, torch.device("cpu"), torch.float32)
        for t, w in zip(got, rope_tables(128, 16, theta, "cpu", torch.float32)):
            torch.testing.assert_close(t, w)
    cos, sin = rope_tables(128, 16, 10.0, "cpu", torch.float32)
    assert cos[5, 0] == pytest.approx(math.cos(5.0), abs=1e-6)
    batch = make_batch(cfg, 2, 128, seed=2)
    valid = batch["attention_mask"].bool()
    with torch.no_grad():
        want = ref.encode(params(model), cfg, batch, batch["input_ids"])
        swapped = model_of(RecformerForSeqRec, cfg.replace(global_rope_theta=10.0,
                                                           local_rope_theta=160000.0))
        got = forward(swapped, batch)[0]
    assert (got[valid] - want[valid]).abs().max() > 1e-3


def test_recipe_holds_the_published_values():
    c = RecformerConfig.modernbert_large()
    assert (c.backbone, c.num_hidden_layers, c.hidden_size, c.num_attention_heads, c.head_dim,
            c.intermediate_size, c.vocab_size, c.max_position_embeddings) == (
        "modernbert", 28, 1024, 16, 64, 2624, 50368, 8192)
    assert [i for i in range(28) if c.is_global_layer(i)] == list(range(0, 28, 3))
    assert (c.local_attention, c.global_rope_theta, c.local_rope_theta) == (128, 160000.0, 10000.0)
    assert c.hidden_dropout_prob == c.attention_probs_dropout_prob == 0.0
    assert (c.pad_token_id, c.bos_token_id, c.sep_token_id, c.mask_token_id) == (
        50283, 50281, 50282, 50284)
    assert (c.hidden_act, c.layer_norm_eps, c.max_token_num, c.max_item_embeddings) == (
        "gelu", 1e-5, 8192, 301)
    with torch.device("meta"):
        m = RecformerForPretraining(c)
    biases = [n for n, _ in m.named_parameters() if n.endswith("bias")]
    assert biases == ["decoder.bias"]
    assert "longformer.layers.0.attn_norm.weight" not in dict(m.named_parameters())
    from recformer_tpu_torch.cli.common import build_config

    assert build_config(argparse.Namespace(model_size="modernbert-large")) == c
    assert RecformerConfig.from_json(c.to_json()) == c


def test_parallelism_is_refused():
    from recformer_tpu_torch.parallel.pipeline import make_pipeline_forward
    from recformer_tpu_torch.parallel.tensor import tp_config

    cfg = tiny()
    with pytest.raises(ValueError, match="tensor parallelism"):
        tp_config(cfg)
    with pytest.raises(ValueError, match="sequence parallelism"):
        cfg.replace(attention_impl="sequence_parallel")
    with pytest.raises(ValueError, match="pipeline parallelism"):
        make_pipeline_forward(model_of(RecformerForSeqRec, cfg).longformer, None, 2)
    with pytest.raises(ValueError, match="without dropout"):
        cfg.replace(hidden_dropout_prob=0.1)
