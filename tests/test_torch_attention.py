"""The port's attention twins and windowed-attention kernel wrapper (its plain
versions, on the CPU) against the JAX package's functions, including the
Pallas kernels in interpret mode. Inputs come from one numpy generator and go
to both stacks; fp32, rtol = atol = 2e-5 for outputs (the JAX kernel tests'
own) and 1e-4 for gradients (``tests/test_pallas_attention.py``'s). Dropout
is held by the same statistical tests as the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.ops import attention as jatt
from recformer_tpu.ops.pallas_attention import pallas_window_attention
from recformer_tpu_torch.ops import attention as tatt
from recformer_tpu_torch.ops import window_attention as wa
from recformer_tpu_torch.ops.window_attention import window_attention

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# the cases of tests/test_pallas_attention.py
CASES = {
    "w8_b16": dict(window=8, block_q=16),
    "w8_b32": dict(window=8, block_q=32),
    "w16_b16": dict(window=16, block_q=16),
    "w16_b32": dict(window=16, block_q=32),
    "no_globals": dict(window=8, block_q=16, global_at_zero=False),
    "item_tower": dict(L=32, n_pad=(0, 9), window=16, block_q=32),
    "window_gt_block": dict(window=32, block_q=16),
    "heads_3x8": dict(H=3, D=8, window=16, block_q=32),
    "heads_12x8": dict(H=12, D=8, window=16, block_q=32),
    "heads_2x128": dict(H=2, D=128, window=16, block_q=32),
    "heads_1x16": dict(H=1, D=16, window=16, block_q=32),
    "extra_global_demoted": dict(window=8, block_q=16, extra_global=True),
    # two kept global rows: the kernel runs without its fused epilogue
    "two_globals_unfused": dict(window=8, block_q=16, extra_global=True, max_globals=2),
}


def make_inputs(seed, B=2, L=64, H=2, D=8, n_pad=(0, 17), global_at_zero=True,
                extra_global=False, **_):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal((B, L, H, D)) * 0.5).astype(np.float32) for _ in range(6)]
    mask = np.ones((B, L), np.int32)
    for b, p in enumerate(n_pad[:B]):
        if p:
            mask[b, L - p:] = 0
    if global_at_zero:
        mask[:, 0] = 2
    if extra_global:
        mask[:, 5] = 2  # a second global row, out of contract
    return arrs, mask


def to_jax(arrs, mask):
    return [jnp.asarray(a) for a in arrs], jnp.asarray(mask)


def to_torch(arrs, mask):
    return [torch.from_numpy(a) for a in arrs], torch.from_numpy(mask)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_attention_matches_pallas_interpret(case):
    kw = CASES[case]
    arrs, mask = make_inputs(0, **kw)
    ja, jm = to_jax(arrs, mask)
    ta, tm = to_torch(arrs, mask)
    G = kw.get("max_globals", 1)
    ref = pallas_window_attention(*ja, jm, kw["window"], block_q=kw["block_q"],
                                  max_globals=G, interpret=True)
    out = window_attention(*ta, tm, kw["window"], max_globals=G)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", ["w8_b16", "w16_b32", "no_globals", "item_tower",
                                  "window_gt_block", "heads_3x8", "heads_2x128"])
def test_twins_match_jax(case):
    kw = CASES[case]
    arrs, mask = make_inputs(1, **kw)
    ja, jm = to_jax(arrs, mask)
    ta, tm = to_torch(arrs, mask)
    W = kw["window"]
    block = min(32, mask.shape[1])
    np.testing.assert_allclose(tatt.dense_attention(*ta, tm, W).numpy(),
                               np.asarray(jatt.dense_attention(*ja, jm, W)), **TOL)
    np.testing.assert_allclose(tatt.chunked_attention(*ta, tm, W, block=block).numpy(),
                               np.asarray(jatt.chunked_attention(*ja, jm, W, block=block)),
                               **TOL)
    # the kernel's plain version against the dense oracle of the port too
    np.testing.assert_allclose(window_attention(*ta, tm, W).numpy(),
                               tatt.dense_attention(*ta, tm, W).numpy(), **TOL)


@pytest.mark.parametrize("compact", [True, False])
def test_global_rows_thin_matches_jax(compact):
    B, L, H, D = 2, 64, 2, 8
    E = H * D
    rng = np.random.default_rng(2)
    qg = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    hidden = rng.standard_normal((B, L, E)).astype(np.float32)
    w_kg, w_vg = ((rng.standard_normal((E, E)) * 0.2).astype(np.float32) for _ in range(2))
    b_kg, b_vg = ((rng.standard_normal(E) * 0.1).astype(np.float32) for _ in range(2))
    mask = np.ones((B, L), np.int32)
    mask[1, L - 17:] = 0
    mask[0, 3] = 2  # row 1 has no global row: its output must be zero
    args = (qg, hidden, w_kg, b_kg, w_vg, b_vg)
    ref = jatt.global_rows_thin(jnp.asarray(hidden), jnp.asarray(qg), jnp.asarray(w_kg),
                                jnp.asarray(b_kg), jnp.asarray(w_vg), jnp.asarray(b_vg),
                                jnp.asarray(mask), jnp.float32, 1, compact=compact)
    t = [torch.from_numpy(a) for a in args]
    out = tatt.global_rows_thin(t[1], t[0], t[2], t[3], t[4], t[5], torch.from_numpy(mask),
                                torch.float32, 1, compact=compact)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[1].any()
    # the materialised projections through _global_rows agree as well
    kg = (hidden @ w_kg + b_kg).reshape(B, L, H, D)
    vg = (hidden @ w_vg + b_vg).reshape(B, L, H, D)
    scale = tatt.attention_scale(D, torch.float32, "cpu")
    full = tatt._global_rows(t[0], torch.from_numpy(kg), torch.from_numpy(vg),
                             torch.from_numpy(mask), scale, torch.float32, 1, compact=compact)
    np.testing.assert_allclose(full.numpy(), out.numpy(), rtol=1e-4, atol=1e-4)


def test_global_prefix_indices_match_jax():
    mask = np.ones((4, 16), np.int32)
    mask[0, 0] = 2
    mask[1, [3, 9]] = 2
    mask[3, 12:] = 0
    mask[3, 15] = 2
    idx_j, valid_j = jatt.global_prefix_indices(jnp.asarray(mask), 2)
    idx_t, valid_t = tatt.global_prefix_indices(torch.from_numpy(mask), 2)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert idx_t[2, 0] == 0 and not valid_t[2, 0]  # no global row: index 0, invalid
    out_g = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 1, 3)
    ref = jatt.scatter_global_rows(jnp.asarray(out_g.numpy()), jnp.asarray(mask), 2)
    np.testing.assert_array_equal(
        tatt.scatter_global_rows(out_g, torch.from_numpy(mask), 2).numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_attention_grads_match_pallas_interpret(case):
    """Autograd through the band core's autograd function (the backward
    kernel's plain version here) against jax.grad through the Pallas
    backward kernel in interpret mode, for all six inputs."""
    kw = CASES[case]
    arrs, mask = make_inputs(4, **kw)
    G = kw.get("max_globals", 1)
    W = kw["window"]
    w = np.random.default_rng(5).standard_normal(arrs[0].shape).astype(np.float32)

    def jloss(*xs):
        out = pallas_window_attention(*xs, jnp.asarray(mask), W, block_q=kw["block_q"],
                                      max_globals=G, interpret=True)
        return jnp.sum(out * w)

    ref = jax.grad(jloss, argnums=tuple(range(6)))(*[jnp.asarray(a) for a in arrs])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = window_attention(*leaves, torch.from_numpy(mask), W, max_globals=G)
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, r in zip(("q", "k", "v", "q_g", "k_g", "v_g"), leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)


BWD_CASES = {
    "w16": dict(window=16),
    "window_gt_tile": dict(window=32),
    "two_globals_unfused": dict(window=8, extra_global=True, max_globals=2),
    "d64_ragged_L": dict(L=200, H=2, D=64, window=64, n_pad=(0, 50)),
}


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_plain_matches_autograd_of_fwd_plain(case, rate):
    """The backward kernel's plain version against torch autograd of the
    forward's plain version, one seed, so one dropout mask: the forward and
    backward masks agree."""
    kw = dict(BWD_CASES[case])
    G = kw.pop("max_globals", 1)
    window = kw.pop("window")
    arrs, mask = make_inputs(6, **kw)
    B, L, H, D = arrs[0].shape
    t = [torch.from_numpy(a) for a in arrs]
    _, ops = wa.prepare_band_inputs(t[0], t[1], t[2], torch.from_numpy(mask), G)
    ops["gout"] = torch.from_numpy(
        np.random.default_rng(7).standard_normal((B, G, H * D)).astype(np.float32))
    fuse = G == 1
    common = dict(num_heads=H, window=window, fuse_epilogue=fuse, dropout_rate=rate, seed=99)
    names = ("q2", "k2", "v2", "gk", "gv", "gout")
    leaves = {n: ops[n].clone().requires_grad_() for n in names}
    out = wa.window_attention_plain(**dict(ops, **leaves), **common)
    dout = torch.from_numpy(np.random.default_rng(8).standard_normal(out.shape).astype(np.float32))
    if not fuse:  # the wrapper zeroes the gradient at global and padding rows
        dout = torch.where(ops["mrow"][:, :, None] == 1, dout, 0.0)
    out.backward(dout)
    got = wa.window_attention_bwd_plain(**ops, dout=dout, **common)
    for n, g in zip(names, got):
        want = leaves[n].grad if leaves[n].grad is not None else torch.zeros_like(g)
        np.testing.assert_allclose(g.numpy(), want.numpy(), err_msg=n, **GRAD_TOL)


def test_dropout_keep_is_one_function_of_absolute_coordinates():
    """The keep mask of a column depends on (seed, b, h, i, c) only, keeps
    about 1 - rate, and its Philox words match the reference's known answer
    (Random123's philox4x32_10 test vector for counter 0, key 0)."""
    zero = torch.zeros((), dtype=torch.int64)
    words = wa.philox4x32_10(zero, zero, zero, zero, 0, 0)
    assert [int(x) for x in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    B, L, H, G, W = 2, 96, 3, 1, 16
    full = wa._keep_mask(5, 0.25, B, L, H, W, G, "cpu")
    i, c = 40, 45
    single = wa.dropout_keep(5, 0.25, torch.tensor(1), torch.tensor(2), torch.tensor(i),
                             torch.tensor(c))
    assert bool(single) == bool(full[1, i, 2, c - (i - W // 2)])
    frac = float(wa._keep_mask(5, 0.25, 4, 512, 4, 64, 1, "cpu").float().mean())
    assert abs(frac - 0.75) < 0.005
    assert not torch.equal(full, wa._keep_mask(6, 0.25, B, L, H, W, G, "cpu"))


def _run_impl(impl, ta, tm, window, rate=0.0, seed=0):
    rng = torch.Generator().manual_seed(seed)
    if impl == "dense":
        return tatt.dense_attention(*ta, tm, window, rate, rng)
    if impl == "chunked":
        return tatt.chunked_attention(*ta, tm, window, block=16, dropout_rate=rate, generator=rng)
    return window_attention(*ta, tm, window, dropout_rate=rate, generator=rng,
                            host_generator=rng)


IMPLS = ["dense", "chunked", "kernel_plain"]


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_deterministic_per_seed_and_off_by_default(impl):
    ta, tm = to_torch(*make_inputs(7))
    clean = _run_impl(impl, ta, tm, 8)
    d1 = _run_impl(impl, ta, tm, 8, 0.5, seed=1)
    d2 = _run_impl(impl, ta, tm, 8, 0.5, seed=1)
    d3 = _run_impl(impl, ta, tm, 8, 0.5, seed=2)
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    assert not np.allclose(d1.numpy(), d3.numpy())
    assert not np.allclose(d1.numpy(), clean.numpy())
    # the global row is dropped too
    assert not np.allclose(d1[:, 0].numpy(), clean[:, 0].numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_is_unbiased(impl):
    """Inverted dropout: the mean over 256 seeds of the dropped output is the
    clean output; padding rows stay exactly zero."""
    ta, tm = to_torch(*make_inputs(8, L=32, n_pad=(0, 5)))
    clean = _run_impl(impl, ta, tm, 8).numpy()
    mean = np.mean([_run_impl(impl, ta, tm, 8, 0.3, seed=s).numpy() for s in range(256)],
                   axis=0)
    np.testing.assert_array_equal(mean[1, -5:], 0.0)
    np.testing.assert_allclose(mean, clean, atol=0.15)


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_grads_flow(impl):
    ta, tm = to_torch(*make_inputs(9))
    leaves = [a.clone().requires_grad_() for a in ta[:3]]
    out = _run_impl(impl, leaves + ta[3:], tm, 8, 0.5, seed=3)
    (out ** 2).sum().backward()
    for leaf in leaves:
        assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0


def test_window_attention_refuses_dropout():
    """The kernel wrapper refuses dropout without a host generator for the
    kernel's seed; given one, dropout runs and changes the output."""
    (ta, tm) = to_torch(*make_inputs(3))
    with pytest.raises(ValueError, match="host_generator"):
        window_attention(*ta, tm, 8, dropout_rate=0.1)
    g = torch.Generator().manual_seed(0)
    out = window_attention(*ta, tm, 8, dropout_rate=0.1, generator=g, host_generator=g)
    assert torch.isfinite(out).all()
    assert not torch.equal(out, window_attention(*ta, tm, 8))


def test_forward_refuses_dropout():
    """The backbone refuses ``deterministic=False`` without an rng; given
    one, dropout runs, the same seed twice gives the same output."""
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.recformer import RecformerModel, init_weights
    from recformer_tpu_torch.utils.rng import StepRNG

    cfg = RecformerConfig.tiny(dtype="float32", attention_impl="pallas")
    model = RecformerModel(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(4, 100, (2, 32), generator=torch.Generator().manual_seed(1))
    att = torch.ones_like(ids)
    glb = torch.zeros_like(ids)
    glb[:, 0] = 1
    args = (ids, att, glb, torch.zeros_like(ids), torch.zeros_like(ids))
    with pytest.raises(ValueError, match="rng"):
        model(*args, deterministic=False)
    clean, _ = model(*args)
    d1, _ = model(*args, deterministic=False, rng=StepRNG(3))
    d2, _ = model(*args, deterministic=False, rng=StepRNG(3))
    assert torch.isfinite(d1).all()
    assert torch.equal(d1, d2) and not torch.equal(d1, clean)


def test_entry_points_refuse_missing_cuda(tmp_path):
    """Called with their default device on a machine without CUDA, the entry
    points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from recformer_tpu_torch.cli import serve
    from recformer_tpu_torch.cli.common import init_model_params, table_to_device
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.item_table import ItemTable
    from recformer_tpu_torch.models.heads import RecformerForSeqRec

    cfg = RecformerConfig.tiny()
    z = np.zeros((2, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        table_to_device(ItemTable(z, z, z, np.zeros(2, np.int32)))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model_params(RecformerForSeqRec(cfg), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--data_path", str(tmp_path), "--sequences", str(tmp_path / "s.json"),
                    "--model_size", "tiny"])
