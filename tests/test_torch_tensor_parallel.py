"""The port's tensor parallelism against the JAX package, on the CPU: a world
of 4 ``gloo`` ranks (data 2 x model 2, ``--device cpu``) fed the JAX weights
and the JAX draws takes one SGD step through kernel 1 and 2's plain versions
at 2 of the 4 heads per rank, held to JAX's one-device step at
``tests/test_tensor_parallel.py``'s tolerances (rtol 1e-4, atol 2e-5), under
both ``global_kv_mode``s; the replicated parameters come out bit-equal on
every rank without an extra reduction; shard-then-gather is the identity;
and the split table names, parameter by parameter, the dims that JAX's
``tp_spec_for`` shards."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _synthetic_table
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data.device_pipeline import make_pretrain_batch
from recformer_tpu.models.heads import RecformerForPretraining as JaxPretrain
from recformer_tpu.parallel.mesh import MODEL_AXIS
from recformer_tpu.parallel.tensor import tp_param_specs
from recformer_tpu.training.steps import TrainState, make_pretrain_step
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForPretraining
from recformer_tpu_torch.parallel.tensor import tp_config, tp_split_dim, validate_tp_config
from recformer_tpu_torch.weights import from_flax_params, torch_name_to_flax_path
from torch_parallel_worker import run_world

TP_TOL = dict(rtol=1e-4, atol=2e-5)
CFG = dict(max_token_num=32, item_seq_len=16, max_item_embeddings=4, attention_window=(8, 8),
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, dtype="float32")
KV_MODES = ("thin", "full")


def t(x):
    return torch.from_numpy(np.array(x))


def setup(global_kv_mode):
    jcfg = JaxConfig.tiny(attention_impl="chunked", global_kv_mode=global_kv_mode, **CFG)
    table = _synthetic_table(jcfg, 12)
    rng = np.random.default_rng(0)
    item_ids = jnp.asarray(rng.integers(0, 12, size=(8, 6)).astype(np.int32))
    seq_lens = jnp.asarray(rng.integers(2, 7, size=8).astype(np.int32))
    model = JaxPretrain(jcfg)
    ba, bb = make_pretrain_batch(jax.random.PRNGKey(0), table, item_ids, seq_lens, jcfg)
    params = model.init(jax.random.PRNGKey(0), ba, bb)
    return jcfg, model, params, table, item_ids, seq_lens


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The JAX one-device SGD step and the port's dp 2 x tp 2 world, per
    ``global_kv_mode``."""
    lr = 1e-2
    want, inputs = {}, []
    for mode in KV_MODES:
        jcfg, model, params, table, item_ids, seq_lens = setup(mode)
        s = TrainState.create(apply_fn=model.apply, params=params, tx=optax.sgd(lr))
        s, m = make_pretrain_step(jcfg, model)(s, jax.random.PRNGKey(1), table, item_ids,
                                              seq_lens)
        want[mode] = (from_flax_params(jax.tree.map(np.asarray, s.params)), float(m["loss"]))
        rng_data, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
        ba, bb = make_pretrain_batch(rng_data, table, item_ids, seq_lens, jcfg)
        inputs.append(dict(
            cfg=dict(CFG, global_kv_mode=mode, attention_impl="pallas",
                     attention_head_shard_axis="model"),
            state={k: v.clone() for k, v in from_flax_params(
                jax.tree.map(np.asarray, params)).items()},
            batch_a={k: t(v) for k, v in ba.items()}, batch_b={k: t(v) for k, v in bb.items()},
            lr=lr))
    ranks = run_world(4, dict(scenarios={"tensor_parallel": 2}, tensor_parallel=inputs),
                      tmp_path_factory.mktemp("world4"))
    return want, ranks


@pytest.mark.parametrize("i,mode", list(enumerate(KV_MODES)))
def test_dp2_tp2_step_matches_jax(world4, i, mode):
    want, ranks = world4
    params, loss = want[mode]
    for r in ranks:
        got = r["tensor_parallel"][i]
        assert got["local_heads"] == 2
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=2e-5)
        for name, w in params.items():
            np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(), err_msg=name,
                                       **TP_TOL)


@pytest.mark.parametrize("i,mode", list(enumerate(KV_MODES)))
def test_replicated_parameters_bit_equal_across_ranks(world4, i, mode):
    """LayerNorms, embeddings and the LM head get equal gradients on every
    rank through ``copy_to`` alone: after the step they are bit-equal."""
    _, ranks = world4
    first = ranks[0]["tensor_parallel"][i]["replicated"]
    assert any("LayerNorm" in k for k in first) and any("embeddings" in k for k in first)
    for r in ranks[1:]:
        for name, v in first.items():
            assert torch.equal(r["tensor_parallel"][i]["replicated"][name], v), name


def test_shard_then_gather_is_the_identity(world4):
    _, ranks = world4
    for r in ranks:
        for got in r["tensor_parallel"]:
            assert got["shard_ok"] and got["gather_ok"]


def test_split_table_matches_jax_specs():
    """Every parameter of the pretraining model: the port splits the torch
    dim that holds the flax kernel's (or bias's) sharded dim."""
    jcfg, model, params, *_ = setup("thin")
    specs = {tuple(k.key for k in path): spec for path, spec in
             jax.tree_util.tree_flatten_with_path(tp_param_specs(params))[0]}
    port = RecformerForPretraining(RecformerConfig.tiny(**CFG))
    n_split = 0
    for name, p in port.named_parameters():
        path, transpose = torch_name_to_flax_path(name)
        spec = tuple(specs[("params", *path)])
        if MODEL_AXIS not in spec:
            want = None
        else:
            flax_dim = spec.index(MODEL_AXIS)
            want = (p.dim() - 1 - flax_dim) if transpose else flax_dim
        assert tp_split_dim(name) == want, (name, spec)
        n_split += want is not None
    # per layer: 6 column kernels + 6 biases, intermediate 2, two row kernels
    assert n_split == jcfg.num_hidden_layers * (12 + 2 + 2)


def test_validate_tp_config():
    cfg = tp_config(RecformerConfig.tiny())
    assert cfg.attention_head_shard_axis == "model"
    validate_tp_config(cfg, 2)
    validate_tp_config(cfg, 4)
    with pytest.raises(ValueError, match="num_attention_heads"):
        validate_tp_config(cfg, 3)
    with pytest.raises(ValueError, match="intermediate_size"):
        validate_tp_config(cfg.replace(intermediate_size=130), 4)
