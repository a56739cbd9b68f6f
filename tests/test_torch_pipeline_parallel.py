"""The port's pipeline parallelism against the JAX package, on the CPU: one
world of 4 ``gloo`` ranks (``--device cpu``) fed the JAX weights
(``from_flax_params``, the stacked ``scan_layers`` layout) and the JAX
batches, against JAX on the 8-device CPU mesh of ``conftest.py``, at
``tests/test_pipeline_parallel.py``'s 4-layer fp32 config and tolerances:

- the pipelined backbone against ``make_pipeline_forward`` at (stages,
  microbatches) (2, 4), (2, 1) (data 2 x pipe 2) and (4, 2) (pipe 4);
- its gradients (each stage's own, summed over the stages) against
  ``jax.grad`` of JAX's pipelined forward in float32 (the embeddings' at a
  wider atol), and against the port's unpipelined backbone in float64;
- the data 2 x pipe 2 step against ``make_pipeline_pretrain_step`` at
  dropout 0, one SGD update; with ``create_optimizer`` and the gradient
  clipped, two AdamW updates against the one-rank step's, the second by a
  one-rank optimizer restored from the pipelined one's whole state;
- remat in the stages (``full``, ``save_attention``) equal to no remat, with
  dropout on;
- the validation errors, with JAX's messages.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from __graft_entry__ import _synthetic_table
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data.device_pipeline import assemble_for_config, make_pretrain_batch
from recformer_tpu.models.heads import RecformerForPretraining as JaxPretrain
from recformer_tpu.models.recformer import RecformerModel as JaxModel
from recformer_tpu.parallel.pipeline import make_pipeline_forward, make_pipeline_pretrain_step
from recformer_tpu.training.steps import TrainState
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForPretraining
from recformer_tpu_torch.models.recformer import RecformerModel
from recformer_tpu_torch.parallel import pipeline as tpipe
from recformer_tpu_torch.weights import from_flax_params
from torch_parallel_worker import assert_adamw_matches_one_rank, run_world

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
EMBEDDING_GRAD_TOL = dict(rtol=2e-4, atol=1e-4)
ADAMW_CLIP = 0.05
CFG = dict(num_hidden_layers=4, attention_window=(8,) * 4, max_token_num=32, item_seq_len=16,
           max_item_embeddings=4, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           dtype="float32", attention_impl="chunked", scan_layers=True)
# (stages, microbatches) -> the scenario that runs it, and its index there
FORWARD_CASES = {(2, 4): ("pp_forward@2", 0), (2, 1): ("pp_forward@2", 1),
                 (4, 2): ("pp_forward@4", 0)}


def t(x):
    return torch.from_numpy(np.array(x))


def to_torch(tree):
    return {k: v.clone() for k, v in from_flax_params(jax.tree.map(np.asarray, tree)).items()}


def backbone_setup():
    cfg = JaxConfig.tiny(**CFG)
    table = _synthetic_table(cfg, 12)
    rng = np.random.default_rng(0)
    item_ids = jnp.asarray(rng.integers(0, 12, size=(8, 6)).astype(np.int32))
    seq_lens = jnp.asarray(rng.integers(2, 7, size=8).astype(np.int32))
    batch = assemble_for_config(table, item_ids, seq_lens, cfg)
    batch = {k: batch[k] for k in ("input_ids", "attention_mask", "global_attention_mask",
                                   "token_type_ids", "item_position_ids")}
    model = JaxModel(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0), **batch), batch


def step_setup():
    cfg = JaxConfig.tiny(**CFG)
    table = _synthetic_table(cfg, 12)
    rng = np.random.default_rng(0)
    item_ids = jnp.asarray(rng.integers(0, 12, size=(8, 6)).astype(np.int32))
    seq_lens = jnp.asarray(rng.integers(2, 7, size=8).astype(np.int32))
    model = JaxPretrain(cfg)
    ba, bb = make_pretrain_batch(jax.random.PRNGKey(0), table, item_ids, seq_lens, cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0), ba, bb), table, item_ids, seq_lens


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world of 4 ranks: the forwards at pipe 2 (data 2 x pipe 2) and
    pipe 4, the data 2 x pipe 2 step, remat in the stages."""
    bcfg, bmodel, bparams, batch = backbone_setup()
    scfg, smodel, sparams, table, item_ids, seq_lens = step_setup()
    rng_data, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    ba, bb = make_pretrain_batch(rng_data, table, item_ids, seq_lens, scfg)
    ta, tb = ({k: t(v) for k, v in b.items()} for b in (ba, bb))
    lr = 1e-2
    port_cfg = dict(CFG, attention_impl="pallas")
    fwd = dict(cfg=port_cfg, state=to_torch(bparams), batch={k: t(v) for k, v in batch.items()})
    inputs = {
        "scenarios": {"pp_forward@2": (2, "pipe"), "pp_step": (2, "pipe"),
                      "model_axis_remat": (2, "pipe"), "model_axis_adamw": (2, "pipe"),
                      "pp_forward@4": (4, "pipe")},
        "pp_forward@2": dict(fwd, microbatches=[4, 1]),
        "pp_forward@4": dict(fwd, microbatches=[2]),
        "pp_step": dict(cfg=port_cfg, state=to_torch(sparams), batch_a=ta, batch_b=tb, lr=lr,
                        microbatches=2),
        "model_axis_remat": dict(kind="pp", cfg=dict(port_cfg, hidden_dropout_prob=0.1,
                                                     attention_probs_dropout_prob=0.1),
                                 state=to_torch(sparams), batch_a=ta, batch_b=tb),
        "model_axis_adamw": dict(kind="pp", cfg=port_cfg, one_cfg=port_cfg,
                                 state=to_torch(sparams), batch_a=ta, batch_b=tb, clip=ADAMW_CLIP),
    }
    ranks = run_world(4, inputs, tmp_path_factory.mktemp("pp_world"))
    return dict(ranks=ranks, backbone=(bmodel, bparams, batch),
                step=(scfg, smodel, sparams, table, item_ids, seq_lens, lr))


@pytest.mark.parametrize("stages,microbatches", list(FORWARD_CASES))
def test_forward_matches_jax(world, stages, microbatches):
    model, params, batch = world["backbone"]
    mesh = Mesh(np.array(jax.devices()[:stages]), ("pipe",))
    hidden, pooled = make_pipeline_forward(model, mesh, microbatches)(params, batch)
    name, i = FORWARD_CASES[stages, microbatches]
    for r in world["ranks"]:
        got = r[name][i]
        np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(hidden), **FWD_TOL)
        np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(pooled), **FWD_TOL)


def test_gradients_match_jax(world):
    """The port's explicit schedule (pipe 2, 4 microbatches; the stage
    layers' gradients summed over the stages, the replicated rest whole on
    every stage) against ``jax.grad`` through JAX's ppermute schedule in
    float32, every gradient but the embeddings' at the JAX test's tolerance.
    The embeddings' small gradients round in float32 to ~1.4e-5 of their
    float64 values (max 2.7e-4), more than the atol of 2e-5 allows between
    two stacks (JAX's model keeps its embedding LayerNorm and softmax in
    float32 under x64 too, so it has no float64 reference): they are held
    to JAX at atol 1e-4, and, with every other gradient, in float64 to the
    port's unpipelined backbone at the JAX test's tolerance."""
    model, params, batch = world["backbone"]
    run = make_pipeline_forward(model, Mesh(np.array(jax.devices()[:2]), ("pipe",)), 4)
    want = from_flax_params(jax.tree.map(
        np.asarray, jax.grad(lambda p: jnp.sum(run(p, batch)[1] ** 2))(params)))
    embeddings = [n for n in want if n.startswith("embeddings.")]
    assert len(embeddings) == 6
    for r in world["ranks"]:
        got = r["pp_forward@2"][0]
        assert set(got["grads"]) == set(want) == set(got["grads64_one_rank"])
        for name, w in want.items():
            np.testing.assert_allclose(got["grads64"][name].numpy(),
                                       got["grads64_one_rank"][name].numpy(), err_msg=name,
                                       **GRAD_TOL)
            np.testing.assert_allclose(got["grads"][name].numpy(), w.numpy(), err_msg=name,
                                       **(EMBEDDING_GRAD_TOL if name in embeddings else GRAD_TOL))


def test_data2_pipe2_step_matches_jax(world):
    cfg, model, params, table, item_ids, seq_lens, lr = world["step"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))
    s = TrainState.create(apply_fn=model.apply, params=params, tx=optax.sgd(lr))
    s, m = make_pipeline_pretrain_step(cfg, model, mesh, num_microbatches=2)(
        s, jax.random.PRNGKey(1), table, item_ids, seq_lens)
    want = from_flax_params(jax.tree.map(np.asarray, s.params))
    ranks = [r["pp_step"] for r in world["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(m["loss"]), rtol=2e-5)
        for name, w in want.items():
            np.testing.assert_allclose(r["params"][name].numpy(), w.numpy(), err_msg=name,
                                       **GRAD_TOL)
    for name in want:  # every rank holds the same whole parameters after the update
        assert all(torch.equal(r["params"][name], ranks[0]["params"][name]) for r in ranks)


def test_data2_pipe2_adamw_step_matches_one_rank(world):
    """``create_optimizer`` with the gradient clipped: every rank holds every
    parameter whole, so its global norm, update and whole AdamW state are the
    one-rank step's, and a one-rank optimizer restored from that state takes
    the next update as the one-rank run does."""
    assert_adamw_matches_one_rank([r["model_axis_adamw"] for r in world["ranks"]], ADAMW_CLIP,
                                  GRAD_TOL)


@pytest.mark.parametrize("policy", ["full", "save_attention"])
def test_remat_in_the_stages_equals_no_remat(world, policy):
    """With dropout on, a stage layer under remat recomputes what it drew:
    the gradients equal no remat's, and the step's generator ends alike."""
    for r in world["ranks"]:
        ref, got = r["model_axis_remat"]["None"], r["model_axis_remat"][policy]
        assert got["after"] == ref["after"]
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        assert any(float(g.abs().max()) > 0 for n, g in ref["grads"].items() if "layer.3" in n)


def test_pipeline_validation():
    """The JAX package's refusals: layers not divisible by the stages, no
    stacked layers, a batch not divisible by the microbatches."""
    cfg = RecformerConfig.tiny(**CFG)
    mesh3 = types.SimpleNamespace(n_model=3, model_rank=0, axis="pipe")
    mesh2 = types.SimpleNamespace(n_model=2, model_rank=0, axis="pipe")
    with pytest.raises(ValueError, match="num_hidden_layers=4 not divisible by pipe axis 3"):
        tpipe.make_pipeline_forward(RecformerModel(cfg), mesh3, 2)
    with pytest.raises(ValueError, match="pipeline parallelism requires scan_layers=True"):
        tpipe.make_pipeline_forward(RecformerModel(cfg.replace(scan_layers=False)), mesh2, 2)
    with pytest.raises(ValueError, match="pipeline parallelism requires scan_layers=True"):
        noscan = cfg.replace(scan_layers=False)
        tpipe.make_pipeline_pretrain_step(noscan, RecformerForPretraining(noscan), None, mesh2, 2)
    run = tpipe.make_pipeline_forward(RecformerModel(cfg), mesh2, 3)
    ids = torch.full((4, 32), 5)
    with pytest.raises(ValueError, match="batch 4 not divisible by microbatches 3"):
        run(dict(input_ids=ids, attention_mask=torch.ones_like(ids),
                 global_attention_mask=torch.zeros_like(ids), token_type_ids=torch.zeros_like(ids),
                 item_position_ids=torch.zeros_like(ids)))


def test_stage_ownership_and_dropout_streams():
    """Each parameter's gradient is contributed by exactly one stage; every
    (layer, microbatch) draws from its own stream."""
    cfg = RecformerConfig.tiny(**CFG)
    names = [n for n, _ in RecformerForPretraining(cfg).named_parameters()]
    owns = [tpipe.owned_by_stage(cfg, 2, s) for s in range(2)]
    assert all(sum(own(n) for own in owns) == 1 for n in names)
    assert owns[1]("longformer.encoder.layer.3.output.dense.weight")
    assert owns[0]("lm_head.bias") and not owns[1]("longformer.embeddings.LayerNorm.bias")
    seeds = {tpipe._layer_rng(11, layer, mb, "cpu").seed for layer in range(4) for mb in range(4)}
    assert len(seeds) == 16
