"""Checkpoint conversion in the port against the JAX package, on the CPU:
the bare-backbone names of ``weights.py`` against the JAX ``RecformerModel``
tree (unrolled and stacked, exact), ``load_torch_checkpoint`` and
``merge_params`` (wrapper prefixes, a ``state_dict`` key, name and shape
matches), and ``cli.convert_ckpt`` against ``recformer_tpu.cli.convert_ckpt``
on one torch pretraining checkpoint: every backbone leaf of ``recformer``,
``seqrec`` and ``fraud`` equal, compared through ``to_flax_params`` (the
fraud heads' initial values differ by design), with the word embeddings
re-injected from a Longformer checkpoint. ``tiny()`` sizes, weights from
seeded generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.cli import convert_ckpt as jax_convert
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.models.recformer import RecformerModel as JaxModel
from recformer_tpu.training.checkpoint import restore_params as jax_restore_params
from recformer_tpu_torch.cli import convert_ckpt as torch_convert
from recformer_tpu_torch.cli.common import init_model_params, maybe_load_pretrained
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import (
    RecformerForFraudDetection,
    RecformerForPretraining,
    RecformerForSeqRec,
)
from recformer_tpu_torch.models.recformer import RecformerModel, init_weights
from recformer_tpu_torch.training.checkpoint import (
    load_torch_checkpoint,
    merge_params,
    restore_params,
)
from recformer_tpu_torch.weights import (
    from_flax_params,
    to_flax_params,
    torch_name_to_flax_path,
)

BATCH_KEYS = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
              "item_position_ids")
WORDS = "longformer.embeddings.word_embeddings.weight"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flat(tree):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("stacked", [False, True], ids=["unrolled", "scan_layers"])
def test_bare_backbone_names_match_the_jax_model_tree(stacked):
    """``RecformerModel``'s own names (no ``longformer.`` prefix) carry the
    JAX ``RecformerModel`` tree both ways, leaf for leaf, in either layout."""
    jcfg = JaxConfig.tiny(scan_layers=stacked)
    batch = {k: jnp.zeros((1, jcfg.max_token_num), jnp.int32) for k in BATCH_KEYS}
    params = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0), **batch))
    sd = from_flax_params(params)
    model = RecformerModel(RecformerConfig.tiny())
    assert set(sd) == set(model.state_dict())
    assert not any(n.startswith("longformer.") for n in sd)
    model.load_state_dict(sd, strict=True)
    want, got = flat(params["params"]), flat(to_flax_params(sd, stacked=stacked))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg="/".join(path))
    assert torch_name_to_flax_path("encoder.layer.1.attention.self.query.weight") == (
        ("encoder", "layer_1", "attention", "self", "query", "kernel"), True)
    assert torch_name_to_flax_path("_forward_module.model.embeddings.LayerNorm.bias") == (
        ("embeddings", "LayerNorm", "bias"), False)


def test_load_torch_checkpoint_and_merge_params(tmp_path):
    """A Lightning/DeepSpeed file (a ``state_dict`` key, ``_forward_module.``
    and ``model.`` prefixes) loads with its names stripped; ``merge_params``
    copies exactly the name and shape matches, in the model's type, and
    leaves the rest of the model as it was."""
    cfg = RecformerConfig.tiny()
    src = RecformerForSeqRec(cfg)
    init_weights(src, cfg, torch.Generator().manual_seed(1))
    sd = src.state_dict()
    wrapped = {f"_forward_module.model.{k}": v for k, v in sd.items()}
    wrapped["_forward_module.model.lm_head.bias"] = torch.zeros(cfg.vocab_size)
    wrapped["_forward_module.model.fc1.weight"] = torch.zeros(3, 3)  # wrong shape
    path = str(tmp_path / "lightning.bin")
    torch.save({"state_dict": wrapped, "epoch": 3}, path)
    loaded = load_torch_checkpoint(path)
    assert set(loaded) == set(sd) | {"lm_head.bias", "fc1.weight"}

    model = RecformerForFraudDetection(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(2))
    head = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("fc")}
    copied, skipped = merge_params(loaded, model, verbose=False)
    assert sorted(copied) == sorted(sd) and sorted(skipped) == ["fc1.weight", "lm_head.bias"]
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k
    for k, v in head.items():
        assert torch.equal(model.state_dict()[k], v), k
    # the CLIs' loader is the same function
    plain = str(tmp_path / "plain.pt")
    torch.save(sd, plain)
    other = maybe_load_pretrained(RecformerForSeqRec(cfg), plain)
    for k, v in sd.items():
        assert torch.equal(other.state_dict()[k], v), k
    # bf16 tensors are copied in the model's type
    merge_params({k: v.bfloat16() for k, v in sd.items()}, other, verbose=False)
    assert all(v.dtype == torch.float32 for v in other.state_dict().values())


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """One tiny pretraining checkpoint (the port's ``RecformerForPretraining``
    state dict in a Lightning wrapper) and a Longformer file with other word
    embeddings, through both CLIs. Returns (source state dict, word table,
    port output dir, JAX output dir)."""
    root = tmp_path_factory.mktemp("convert")
    cfg = RecformerConfig.tiny()
    pre = RecformerForPretraining(cfg)
    init_weights(pre, cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        pre.lm_head.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(4))
    sd = pre.state_dict()
    src = str(root / "pretrain.bin")
    torch.save({"state_dict": {f"_forward_module.model.{k}": v for k, v in sd.items()}}, src)
    words = torch.randn(sd[WORDS].shape, generator=torch.Generator().manual_seed(5))
    lf = str(root / "longformer.bin")
    torch.save({WORDS: words, "longformer.pooler.dense.weight": torch.zeros(2, 2)}, lf)
    args = ["--pretrain_ckpt", src, "--model_size", "tiny", "--longformer_ckpt", lf]
    torch_convert.main(args + ["--output_dir", str(root / "torch"), "--device", "cpu"])
    jax_convert.main(args + ["--output_dir", str(root / "jax")])
    return sd, words, root / "torch", root / "jax"


def test_convert_ckpt_backbones_equal_the_jax_cli(converted):
    """Every backbone leaf of the three outputs equals the JAX CLI's bit for
    bit, and the source's (the word table the Longformer file's); the
    outputs hold exactly their models' names; the JAX CLI's fraud head is
    the one leaf set left out (its initial values differ by design)."""
    sd, words, tout, jout = converted
    cfg = RecformerConfig.tiny()
    want_sd = {**sd, WORDS: words}
    for name, cls in (("recformer", RecformerModel), ("seqrec", RecformerForSeqRec),
                      ("fraud", RecformerForFraudDetection)):
        got = restore_params(str(tout / f"{name}.pt"))
        assert set(got) == set(cls(cfg).state_dict()), name
        theirs = flat(jax_restore_params(str(jout / name))["params"])
        mine = flat(to_flax_params(got))
        assert set(mine) == set(theirs), name
        backbone = [p for p in theirs if p[0] not in ("fc1", "fc2", "fc3")]
        assert len(backbone) == len(theirs) - 6 * (name == "fraud")
        for path in backbone:
            np.testing.assert_array_equal(mine[path], theirs[path],
                                          err_msg=f"{name}: {'/'.join(path)}")
        prefix = "" if name == "recformer" else "longformer."
        for k, v in want_sd.items():
            if k.startswith("longformer."):
                assert torch.equal(got[prefix + k.removeprefix("longformer.")], v), (name, k)


def test_convert_ckpt_outputs_load_into_their_models(converted, tmp_path):
    """``recformer.pt`` loads strictly into ``RecformerModel``; ``fraud.pt``
    and ``seqrec.pt`` load into the fraud and seq-rec CLIs' models with every
    tensor copied; the fraud head is the seeded initialiser's; a source
    without wrappers converts to the same files."""
    sd, _, tout, _ = converted
    cfg = RecformerConfig.tiny()
    RecformerModel(cfg).load_state_dict(restore_params(str(tout / "recformer.pt")),
                                         strict=True)
    for name, cls in (("fraud", RecformerForFraudDetection), ("seqrec", RecformerForSeqRec)):
        model = cls(cfg)
        copied, skipped = merge_params(load_torch_checkpoint(str(tout / f"{name}.pt")),
                                       model, verbose=False)
        assert skipped == [] and sorted(copied) == sorted(model.state_dict()), name
    fresh = init_model_params(RecformerForFraudDetection(cfg), cfg, "cpu")
    fraud = restore_params(str(tout / "fraud.pt"))
    for k in ("fc1.weight", "fc1.bias", "fc2.weight", "fc3.weight"):
        assert torch.equal(fraud[k], fresh.state_dict()[k]), k
    plain = str(tmp_path / "best.pt")
    torch.save(sd, plain)
    torch_convert.main(["--pretrain_ckpt", plain, "--model_size", "tiny", "--output_dir",
                        str(tmp_path / "out"), "--device", "cpu"])
    for name in ("recformer", "seqrec", "fraud"):
        a = restore_params(str(tmp_path / "out" / f"{name}.pt"))
        b = restore_params(str(tout / f"{name}.pt"))
        for k in a:
            if "word_embeddings" not in k:
                assert torch.equal(a[k], b[k]), (name, k)
    assert RecformerConfig.load(str(tmp_path / "out" / "config.json")) == cfg
