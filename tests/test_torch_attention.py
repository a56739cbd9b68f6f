"""The port's attention twins and windowed-attention kernel wrapper (its plain
version, on the CPU) against the JAX package's functions, including the
Pallas kernel in interpret mode. Inputs come from one numpy generator and go
to both stacks; fp32, rtol = atol = 2e-5 (the JAX kernel tests' own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.ops import attention as jatt
from recformer_tpu.ops.pallas_attention import pallas_window_attention
from recformer_tpu_torch.ops import attention as tatt
from recformer_tpu_torch.ops.window_attention import window_attention

TOL = dict(rtol=2e-5, atol=2e-5)

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


def test_window_attention_refuses_dropout():
    (ta, tm) = to_torch(*make_inputs(3))
    with pytest.raises(NotImplementedError):
        window_attention(*ta, tm, 8, dropout_rate=0.1)


def test_forward_refuses_dropout():
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.recformer import RecformerModel

    model = RecformerModel(RecformerConfig.tiny(dtype="float32"))
    ids = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        model(ids, ids, ids, ids, ids, deterministic=False)


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
