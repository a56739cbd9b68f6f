"""The port's LayerNorm kernels' modules against the JAX package's, on the
CPU: ``ops/layernorm.py`` against ``pallas_layernorm`` (Pallas backward in
interpret mode) and ``split_layernorm``, ``ops/embed_layernorm.py`` against
``fused_embed_layernorm`` (interpret mode), each plain backward against
autograd of its plain forward, the model's dispatch on ``ln_impl`` and
``embed_ln_impl``, and the parameter names under every value. Inputs from
seeded numpy generators; each tolerance is stated where it is used. The
CUDA kernels themselves are held to these plain versions on the card
(``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.models.heads import RecformerForPretraining as JaxPretrain
from recformer_tpu.models.recformer import RecformerModel as JaxModel
from recformer_tpu.ops.pallas_embed import fused_embed_layernorm as jax_fused_embed
from recformer_tpu.ops.pallas_layernorm import pallas_layernorm, split_layernorm as jax_split
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.embeddings import (RecformerEmbeddings,
                                                   create_position_ids_from_input_ids)
from recformer_tpu_torch.models.encoder import BlockOutput
from recformer_tpu_torch.models.heads import RecformerForPretraining
from recformer_tpu_torch.models.recformer import RecformerModel, init_weights
from recformer_tpu_torch.ops import embed_layernorm as tel
from recformer_tpu_torch.ops import layernorm as tln
from recformer_tpu_torch.weights import from_flax_params

EPS = 1e-5
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 values (tests/test_pallas_layernorm.py)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)   # fp32 gradients (the same file)


def bf16_ulp(ref):
    """One bf16 ulp of each (bf16-valued) reference element."""
    return np.spacing(np.abs(np.asarray(ref, np.float32))) * 2.0 ** 16


def as_bf16_np(x):
    """float32 numpy values of ``x`` rounded to bf16 (the inputs both stacks get)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def jax_ln(impl):
    if impl == "pallas_bwd":
        return lambda x, s, b: pallas_layernorm(x, s, b, EPS, True)
    return lambda x, s, b: jax_split(x, s, b, EPS)


def torch_ln(impl):
    return tln.fused_bwd_layernorm if impl == "pallas_bwd" else tln.split_layernorm


def ln_params(rng, H, spread=1.0):
    gamma = (1.0 + spread * rng.standard_normal(H)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(H)).astype(np.float32)
    return gamma, beta


# ---------------------------------------------------------------------------
# repairs: the encoder block's LayerNorm and the embedding sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas_bwd", "split_bwd"])
def test_block_layernorm_forward_matches_jax_at_an_offset(impl):
    """Rows of 768 around 300: flax's fast variance loses about 0.05 there,
    the two-pass forward does not. The block's dense output is zeroed so its
    LayerNorm sees the residual alone. fp32, abs <= 1e-4 against JAX and
    against a float64 evaluation: a float32 mean near 300 is good to half
    an ulp (1.5e-5), which every centred value carries."""
    rng = np.random.default_rng(0)
    H = 768
    x = (rng.standard_normal((2, 16, H)) + 300.0).astype(np.float32)
    gamma, beta = ln_params(rng, H, spread=0.1)
    cfg = RecformerConfig.tiny(hidden_size=H, num_attention_heads=12, intermediate_size=H,
                               dtype="float32", ln_impl=impl)
    block = BlockOutput(cfg, H)
    with torch.no_grad():
        block.dense.weight.zero_()
        block.dense.bias.zero_()
        block.LayerNorm.weight.copy_(torch.from_numpy(gamma))
        block.LayerNorm.bias.copy_(torch.from_numpy(beta))
        out = block(torch.zeros(2, 16, H), torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_ln(impl)(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    x64 = x.astype(np.float64)
    xc = x64 - x64.mean(-1, keepdims=True)
    exact = xc / np.sqrt((xc * xc).mean(-1, keepdims=True) + EPS) * gamma + beta
    np.testing.assert_allclose(out, exact, rtol=0, atol=1e-4)


def test_embedding_kernel_path_matches_jax_kernel_in_bf16():
    """``embed_ln_impl='pallas'`` in bf16 against ``fused_embed_layernorm``
    in interpret mode on the same gathered rows: both sum the four bf16
    addends in float32. At most one bf16 ulp per element, and at most 1% of
    the elements differing (a compute-type sum differs in about 44%)."""
    H = 768
    cfg = RecformerConfig.tiny(hidden_size=H, num_attention_heads=12, intermediate_size=H,
                               dtype="bfloat16", embed_ln_impl="pallas",
                               initializer_range=0.5)
    emb = RecformerEmbeddings(cfg)
    init_weights(emb, cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        emb.LayerNorm.weight.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    B, L = 2, 64
    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(B, L)))
    types = torch.from_numpy(rng.integers(0, cfg.token_type_size, size=(B, L)))
    items = torch.from_numpy(rng.integers(0, cfg.max_item_embeddings, size=(B, L)))
    with torch.no_grad():
        out = emb(ids, types, items).float().numpy()
    pos = create_position_ids_from_input_ids(ids, cfg.pad_token_id)
    rows = [np.asarray(table.weight.detach()[i].numpy()) for table, i in (
        (emb.word_embeddings, ids), (emb.position_embeddings, pos),
        (emb.token_type_embeddings, types), (emb.item_position_embeddings, items))]
    ref = jax_fused_embed(*[jnp.asarray(r).astype(jnp.bfloat16) for r in rows],
                          jnp.asarray(emb.LayerNorm.weight.detach().numpy()),
                          jnp.asarray(emb.LayerNorm.bias.detach().numpy()),
                          eps=cfg.layer_norm_eps, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(out - ref)
    assert (diff <= bf16_ulp(ref)).all(), float(diff.max())
    assert (diff > 0).mean() <= 0.01, float((diff > 0).mean())


# ---------------------------------------------------------------------------
# the block LayerNorm functions against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas_bwd", "split_bwd"])
@pytest.mark.parametrize("shape", [(4, 32, 64), (3, 37, 128)])
def test_block_layernorm_value_and_grads_match_jax_fp32(impl, shape):
    """fp32 values (1e-5) and the gradients of x, gamma and beta (rtol 2e-4,
    atol 1e-5); (3, 37) is an odd row count."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    gamma, beta = ln_params(rng, shape[-1])
    dy = rng.standard_normal(shape).astype(np.float32)
    ref, vjp = jax.vjp(jax_ln(impl), jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    grads_ref = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    out = torch_ln(impl)(*args, EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **VALUE_TOL)
    grads = torch.autograd.grad(out, args, torch.from_numpy(dy))
    for name, g, r in zip(("dx", "dgamma", "dbeta"), grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("impl", ["pallas_bwd", "split_bwd"])
def test_block_layernorm_value_and_grads_match_jax_bf16(impl):
    """bf16 x and dout over float32 gamma/beta, as in the model. Values: at
    most one bf16 ulp. dx (bf16): within one bf16 ulp of the largest |dx|
    (its float32 math runs in another summation order and rounds once).
    dgamma/dbeta (float32 sums of bf16-valued terms): rtol 1e-4 of the
    largest value. ``pallas_bwd`` rounds gamma to bf16 in the backward,
    ``split_bwd`` keeps it in float32; each side does the same as JAX."""
    rng = np.random.default_rng(4)
    shape = (3, 37, 128)
    x = as_bf16_np((rng.standard_normal(shape) * 2.0).astype(np.float32))
    dy = as_bf16_np(rng.standard_normal(shape).astype(np.float32))
    gamma, beta = ln_params(rng, shape[-1])
    bf = jnp.bfloat16
    ref, vjp = jax.vjp(jax_ln(impl), jnp.asarray(x).astype(bf), jnp.asarray(gamma),
                       jnp.asarray(beta))
    grads_ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy).astype(bf))]
    ref = np.asarray(ref.astype(jnp.float32))
    args = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(),
            torch.from_numpy(gamma).requires_grad_(), torch.from_numpy(beta).requires_grad_()]
    out = torch_ln(impl)(*args, EPS)
    assert out.dtype == torch.bfloat16
    assert (np.abs(out.detach().float().numpy() - ref) <= bf16_ulp(ref)).all()
    dx, dgamma, dbeta = torch.autograd.grad(out, args, torch.from_numpy(dy).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dgamma.dtype == torch.float32
    dx_err = np.abs(dx.float().numpy() - grads_ref[0]).max()
    assert dx_err <= bf16_ulp(np.abs(grads_ref[0]).max()), dx_err
    for name, g, r in (("dgamma", dgamma, grads_ref[1]), ("dbeta", dbeta, grads_ref[2])):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(4, 32, 64), (3, 37, 128)])
def test_layernorm_bwd_plain_matches_autograd_of_the_forward(shape):
    """The backward kernel's plain version against autograd of
    ``ln_forward_math``, fp32 (rtol 2e-4, atol 1e-5), over an odd row count
    too."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    gamma, beta = ln_params(rng, shape[-1])
    dy = rng.standard_normal(shape).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    want = torch.autograd.grad(tln.ln_forward_math(*args, EPS), args, torch.from_numpy(dy))
    H = shape[-1]
    got = tln.layernorm_bwd_plain(torch.from_numpy(x).reshape(-1, H), torch.from_numpy(gamma),
                                  torch.from_numpy(dy).reshape(-1, H), EPS)
    for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), w.numpy(), err_msg=name,
                                   **GRAD_TOL)


def _bwd_with_gamma_rounded_by_the_caller(x, gamma_t, dout, eps):
    """The backward's plain arithmetic under the contract in which the
    caller hands over gamma already rounded to x's type (``gamma_t``) and the
    function widens it: the rounding order the kernel keeps."""
    x32, dy = x.float(), dout.float()
    inv_h = 1.0 / x.shape[-1]
    mu = x32.sum(-1, keepdim=True) * inv_h
    xc = x32 - mu
    var = (xc * xc).sum(-1, keepdim=True) * inv_h
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    dyg = dy * gamma_t.float()
    m1 = dyg.sum(-1, keepdim=True) * inv_h
    m2 = (dyg * xhat).sum(-1, keepdim=True) * inv_h
    dx = rstd * (dyg - m1 - xhat * m2)
    return dx.to(x.dtype), (dy * xhat).sum(0), dy.sum(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_bwd_plain_rounds_float32_gamma_itself(dtype):
    """Given the float32 parameter, the plain backward rounds gamma to x's
    type itself (as the kernel does) and returns, bit for bit, what the
    backward gives when the caller rounds gamma first. In bf16 the gamma is
    chosen off the bf16 grid, so that a backward which skipped the rounding
    would differ."""
    rng = np.random.default_rng(11)
    M, H = 203, 768
    x = torch.from_numpy((rng.standard_normal((M, H)) * 2.0).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.standard_normal((M, H)).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32))
    got = tln.layernorm_bwd_plain(x, gamma, dout, EPS)
    want = _bwd_with_gamma_rounded_by_the_caller(x, gamma.to(dtype), dout, EPS)
    for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if dtype == torch.bfloat16:
        assert not torch.equal(gamma.to(dtype).float(), gamma)
        unrounded = _bwd_with_gamma_rounded_by_the_caller(x, gamma, dout, EPS)
        assert not torch.equal(unrounded[0], got[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [64, 768])
@pytest.mark.parametrize("M", [1, 37, 8 * 25 + 3])
def test_layernorm_bwd_plain_matches_jax_at_ragged_rows(M, H, dtype):
    """The plain backward, given the float32 gamma, against ``jax.vjp`` of
    ``pallas_layernorm`` (Pallas backward in interpret mode) at row counts
    that a persistent grid's edges meet: one row, a prime, a multiple of 8
    plus 3. float32: each output within 1e-5 (rtol and atol). bf16: dx
    within one bf16 ulp of the largest |dx|, dgamma/dbeta within 1e-4 of
    their largest value (float32 sums in another order)."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((M, H)) * 2.0).astype(np.float32)
    dy = rng.standard_normal((M, H)).astype(np.float32)
    gamma, beta = ln_params(rng, H, spread=0.1)
    if dtype == "bfloat16":
        x, dy = as_bf16_np(x), as_bf16_np(dy)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(jax_ln("pallas_bwd"), jnp.asarray(x).astype(jdt), jnp.asarray(gamma),
                     jnp.asarray(beta))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy).astype(jdt))]
    got = tln.layernorm_bwd_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
                                  torch.from_numpy(dy).to(tdt), EPS)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    got = [g.float().numpy() for g in got]
    if dtype == "float32":
        for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        return
    dx_err = np.abs(got[0] - want[0]).max()
    assert dx_err <= bf16_ulp(np.abs(want[0]).max()), dx_err
    for name, g, w in (("dgamma", got[1], want[1]), ("dbeta", got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the fused embedding LayerNorm against JAX's
# ---------------------------------------------------------------------------

def embed_inputs(rng, shape):
    adds = [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(4)]
    gamma, beta = ln_params(rng, shape[-1], spread=0.1)
    return adds, gamma, beta


@pytest.mark.parametrize("shape", [(2, 32, 64), (3, 37, 128)])
def test_fused_embed_layernorm_value_and_grads_match_jax_fp32(shape):
    """fp32 values (1e-5) and the gradients of all four addends, gamma and
    beta (rtol 2e-4, atol 1e-5). JAX's wrapper needs its block to divide the
    rows and halves it until it does; the port takes any row count."""
    rng = np.random.default_rng(6)
    adds, gamma, beta = embed_inputs(rng, shape)
    dy = rng.standard_normal(shape).astype(np.float32)

    def jf(a, b, c, d, g, bt):
        return jax_fused_embed(a, b, c, d, g, bt, eps=EPS, interpret=True)

    ref, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in (*adds, gamma, beta)])
    grads_ref = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(a).requires_grad_() for a in (*adds, gamma, beta)]
    out = tel.fused_embed_layernorm(*args, EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **VALUE_TOL)
    grads = torch.autograd.grad(out, args, torch.from_numpy(dy))
    names = ("dword", "dpos", "dtype", "ditem", "dgamma", "dbeta")
    for name, g, r in zip(names, grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)


def test_fused_embed_layernorm_grads_match_jax_bf16():
    """bf16 addends and dout: the one dx of the four addends within one bf16
    ulp of the largest |dx|, dgamma/dbeta within 1e-4 of their largest
    value (float32 sums in another order)."""
    rng = np.random.default_rng(7)
    shape = (2, 32, 128)
    adds, gamma, beta = embed_inputs(rng, shape)
    adds = [as_bf16_np(a) for a in adds]
    dy = as_bf16_np(rng.standard_normal(shape).astype(np.float32))
    bf = jnp.bfloat16

    def jf(a, b, c, d, g, bt):
        return jax_fused_embed(a, b, c, d, g, bt, eps=EPS, interpret=True)

    _, vjp = jax.vjp(jf, *[jnp.asarray(a).astype(bf) for a in adds], jnp.asarray(gamma),
                     jnp.asarray(beta))
    grads_ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy).astype(bf))]
    args = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in adds]
    args += [torch.from_numpy(gamma).requires_grad_(), torch.from_numpy(beta).requires_grad_()]
    out = tel.fused_embed_layernorm(*args, EPS)
    grads = torch.autograd.grad(out, args, torch.from_numpy(dy).to(torch.bfloat16))
    for g, r in zip(grads[:4], grads_ref[:4]):
        assert g.dtype == torch.bfloat16
        assert np.abs(g.float().numpy() - r).max() <= bf16_ulp(np.abs(r).max())
    for name, g, r in zip(("dgamma", "dbeta"), grads[4:], grads_ref[4:]):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


def test_embed_layernorm_bwd_plain_matches_autograd_of_the_forward():
    """The backward kernel's plain version against autograd of the forward's
    (the shared dx summed over the four addends' gradients equals 4 dx),
    fp32, an odd row count; rtol 2e-4, atol 1e-5."""
    rng = np.random.default_rng(8)
    shape = (111, 64)
    adds, gamma, beta = embed_inputs(rng, shape)
    dy = rng.standard_normal(shape).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_() for a in (*adds, gamma, beta)]
    want = torch.autograd.grad(tel.embed_layernorm_plain(*args, EPS), args, torch.from_numpy(dy))
    dx, dgamma, dbeta = tel.embed_layernorm_bwd_plain(
        *[torch.from_numpy(a) for a in adds], torch.from_numpy(gamma), torch.from_numpy(dy), EPS)
    for w in want[:4]:
        np.testing.assert_allclose(dx.numpy(), w.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dgamma.numpy(), want[4].numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dbeta.numpy(), want[5].numpy(), **GRAD_TOL)


def test_kernel_wrappers_refuse_devices_other_than_cuda_and_cpu():
    x = torch.empty(4, 64, device="meta")
    g = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tln.layernorm_bwd(x, g, x, EPS)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tel.embed_layernorm_fwd(x, x, x, x, g, g, EPS)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tel.embed_layernorm_bwd(x, x, x, x, g, x, EPS)


# ---------------------------------------------------------------------------
# the model under the LayerNorm flags
# ---------------------------------------------------------------------------

FLAG_SETS = [dict(), dict(ln_impl="pallas_bwd"), dict(ln_impl="split_bwd"),
             dict(embed_ln_impl="pallas", ln_impl="pallas_bwd")]


def tiny_batch(cfg, seed, B=2):
    rng = np.random.default_rng(seed)
    L = 32
    ids = rng.integers(4, cfg.vocab_size, size=(B, L)).astype(np.int32)
    attn = np.ones((B, L), np.int32)
    attn[1, 20:] = 0
    ids[1, 20:] = cfg.pad_token_id
    glob = np.zeros((B, L), np.int32)
    glob[:, 0] = 1
    types = rng.integers(1, 3, size=(B, L)).astype(np.int32)
    items = rng.integers(0, cfg.max_item_embeddings, size=(B, L)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": attn, "global_attention_mask": glob,
            "token_type_ids": types, "item_position_ids": items}


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "-".join(f.values()) or "xla")
def test_backbone_under_the_layernorm_flags_matches_jax(flags):
    """fp32 hidden states and pooled outputs of the backbone within 1e-4 of
    JAX's under the same ``ln_impl``. JAX's model cannot run its embedding
    kernel on the CPU outside interpret mode, so the port's
    ``embed_ln_impl='pallas'`` is held to JAX's ``'xla'``: in fp32 the two
    sums are the same float32 additions."""
    kw = dict(hidden_act="gelu_tanh", dtype="float32", attention_impl="pallas",
              initializer_range=0.1)
    jcfg = JaxConfig.tiny(**kw, ln_impl=flags.get("ln_impl", "xla"))
    tcfg = RecformerConfig.tiny(**kw, **flags)
    batch = tiny_batch(jcfg, 9)
    params = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(1), **{k: jnp.asarray(v) for k, v in batch.items()}))
    h_j, p_j = JaxModel(jcfg).apply(params, **{k: jnp.asarray(v) for k, v in batch.items()})
    model = RecformerModel(tcfg)
    sd = {k.removeprefix("longformer."): v for k, v in
          from_flax_params({"params": {"longformer": params["params"]}}).items()}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        h_t, p_t = model(**{k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-4, atol=1e-4)


def test_parameter_names_are_the_same_under_every_layernorm_flag():
    """One state dict for every flag set, the one the JAX tree maps to
    (its tree is the same under every ``ln_impl``)."""
    kw = dict(hidden_act="gelu_tanh", dtype="float32")
    z = jnp.zeros((1, 32), jnp.int32)
    batch = {k: z for k in ("input_ids", "attention_mask", "global_attention_mask",
                            "token_type_ids", "item_position_ids", "mlm_input_ids")}
    batch["mlm_positions"] = jnp.zeros((1, 8), jnp.int32)
    flax_sd = from_flax_params(jax.tree.map(np.asarray, JaxPretrain(JaxConfig.tiny(**kw)).init(
        jax.random.PRNGKey(0), batch, batch)))
    shapes = None
    for flags in FLAG_SETS:
        model = RecformerForPretraining(RecformerConfig.tiny(**kw, **flags))
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        shapes = shapes or got
        assert got == shapes, flags
        model.load_state_dict(flax_sd, strict=True)
