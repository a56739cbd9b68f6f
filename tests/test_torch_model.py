"""The port's backbone against the JAX package's, with the weights carried by
``from_flax_params`` (and, the other way, by the JAX package's own
``import_torch_state_dict``). fp32, attention through the windowed kernel
(its plain version here; the Pallas kernel in interpret mode on the JAX
side); hidden states and pooled outputs agree within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data.device_pipeline import assemble_for_config as jax_assemble
from recformer_tpu.models.heads import RecformerForSeqRec as JaxSeqRec
from recformer_tpu.models.recformer import RecformerModel as JaxModel
from recformer_tpu.training.checkpoint import import_torch_state_dict
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForSeqRec
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.weights import from_flax_params, to_flax_params

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH_KEYS = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
              "item_position_ids")

CONFIGS = {
    "tiny_cls": dict(),
    "tiny_avg": dict(pooler_type="avg"),
    "d64": dict(hidden_size=128, num_attention_heads=2, intermediate_size=256),
}


def synthetic_table(cfg, n_items, seed=0):
    rng = np.random.default_rng(seed)
    M = cfg.max_item_token_len
    ids = rng.integers(4, cfg.vocab_size - 1, size=(n_items + 1, M)).astype(np.int32)
    types = np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32), (n_items + 1, 1))
    begin = rng.integers(0, 2, size=(n_items + 1, M)).astype(np.int32)
    lengths = rng.integers(3, M + 1, size=n_items + 1).astype(np.int32)
    ids[-1] = cfg.pad_token_id
    lengths[-1] = 0
    return {"token_ids": ids, "token_types": types, "word_begin": begin, "lengths": lengths}


def make_batch(cfg, seed, B=3, S_in=6, out_len=64):
    """An assembled batch with one short history (padding rows) and one
    history long enough to be truncated."""
    rng = np.random.default_rng(seed)
    table = {k: jnp.asarray(v) for k, v in synthetic_table(cfg, 30, seed).items()}
    item_ids = rng.integers(0, 30, size=(B, S_in)).astype(np.int32)
    seq_lens = np.array([1, S_in, 3][:B], np.int32)
    b = jax_assemble(table, jnp.asarray(item_ids), jnp.asarray(seq_lens), cfg, out_len=out_len)
    return {k: np.asarray(b[k]) for k in BATCH_KEYS}


def configs(name):
    kw = dict(attention_impl="pallas", hidden_act="gelu_tanh", dtype="float32", **CONFIGS[name])
    return JaxConfig.tiny(**kw), RecformerConfig.tiny(**kw)


def jax_forward(jcfg, params, batch):
    hidden, pooled = JaxModel(jcfg).apply({"params": params["params"]["longformer"]},
                                          **{k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(hidden), np.asarray(pooled)


def torch_forward(model, batch):
    with torch.no_grad():
        hidden, pooled = model.longformer(**{k: torch.from_numpy(v) for k, v in batch.items()})
    return hidden.numpy(), pooled.numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("out_len", [32, 64])
def test_backbone_matches_jax(name, out_len):
    jcfg, tcfg = configs(name)
    batch = make_batch(jcfg, seed=1, out_len=out_len)
    params = JaxSeqRec(jcfg).init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(np.asarray, params)
    model = RecformerForSeqRec(tcfg)
    model.load_state_dict(from_flax_params(params), strict=True)
    h_j, p_j = jax_forward(jcfg, params, batch)
    h_t, p_t = torch_forward(model, batch)
    np.testing.assert_allclose(h_t, h_j, **TOL)
    np.testing.assert_allclose(p_t, p_j, **TOL)


def test_state_dict_round_trips_through_jax_importer():
    jcfg, tcfg = configs("tiny_cls")
    batch = make_batch(jcfg, seed=2)
    model = RecformerForSeqRec(tcfg)
    init_weights(model, tcfg, torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    template = JaxSeqRec(jcfg).init(jax.random.PRNGKey(0),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    params, copied, skipped = import_torch_state_dict(sd, template, strict=True, verbose=False)
    assert skipped == [] and len(copied) == len(sd)
    flat_ours = jax.tree_util.tree_leaves_with_path(to_flax_params(model.state_dict()))
    flat_theirs = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    assert len(flat_ours) == len(flat_theirs)
    for path, leaf in flat_ours:
        np.testing.assert_array_equal(leaf, np.asarray(flat_theirs[path]))
    # and the imported weights give the JAX backbone the port's outputs
    h_j, p_j = jax_forward(jcfg, params, batch)
    h_t, p_t = torch_forward(model, batch)
    np.testing.assert_allclose(p_t, p_j, **TOL)
    np.testing.assert_allclose(h_t, h_j, **TOL)


def test_from_flax_params_rejects_unknown_leaves():
    with pytest.raises(KeyError):
        from_flax_params({"params": {"longformer": {"mystery": {"kernel": np.zeros(2)}}}})


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_plain_twins_in_the_model_match_the_kernel_path(impl):
    jcfg, tcfg = configs("tiny_cls")
    batch = make_batch(jcfg, seed=4)
    model = RecformerForSeqRec(tcfg)
    init_weights(model, tcfg, torch.Generator().manual_seed(5))
    other = RecformerForSeqRec(tcfg.replace(attention_impl=impl))
    other.load_state_dict(model.state_dict())
    np.testing.assert_allclose(torch_forward(other, batch)[0], torch_forward(model, batch)[0],
                               **TOL)
