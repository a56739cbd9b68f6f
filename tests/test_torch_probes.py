"""The port's two band probes (kernels 6 and 7 of the kernel table) against
the reference's Pallas kernels.

The reference kernels are built from ``benchmarks/kernel_ablation.py`` and
``benchmarks/headpair_probe.py``'s own ``make_kernel`` with the same
``BlockSpec``s as their ``run_variant``, run by ``pl.pallas_call(...,
interpret=True)`` on the CPU, and held against the port's plain versions
on the same numpy inputs: float32 within 1e-5 of ``max|ref|``, bfloat16
within 1e-2 (the scores and exponentials round to bf16 before P.V, where
the two stacks' product orders differ). The scripts are loaded by file
path; importing them sets a compilation-cache directory and nothing else.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from recformer_tpu_torch.ops import band_probes as bp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ablation_ref():
    return _load("kernel_ablation")


@pytest.fixture(scope="module")
def headpair_ref():
    return _load("headpair_probe")


def ablation_inputs(seed, B, L, H, W, G, dtype, zero_keys=(), gvalid_zero=()):
    """Inputs in the reference's layout: K/V/keyloc padded by W/2 rows at
    each end (keyloc 0 there); ``zero_keys`` are sequence positions whose
    keyloc is 0, ``gvalid_zero`` the (batch, global) pairs marked invalid."""
    rng = np.random.default_rng(seed)
    HD = H * bp.HEAD_DIM
    half = W // 2
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    q = f(B, L, HD)
    pad = ((0, 0), (half, half), (0, 0))
    kpad, vpad = np.pad(f(B, L, HD), pad), np.pad(f(B, L, HD), pad)
    keyloc = np.ones((B, L), np.int32)
    for j in zero_keys:
        keyloc[:, j] = 0
    keyloc = np.pad(keyloc, ((0, 0), (half, half)))[:, :, None]
    gk, gv = f(B, G, HD), f(B, G, HD)
    gvalid = np.ones((B, 1, G), np.int32)
    for b, g in gvalid_zero:
        gvalid[b, 0, g] = 0
    floats = [q, kpad, vpad, gk, gv]
    if dtype == "bfloat16":  # the same bf16 values in both stacks
        floats = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in floats]
    q, kpad, vpad, gk, gv = floats
    return dict(q=q, kpad=kpad, vpad=vpad, keyloc=keyloc, gk=gk, gv=gv, gvalid=gvalid)


def ablation_pallas(ref, ins, variant, block_q, W, H):
    """``run_variant``'s pallas_call, in interpret mode."""
    q = jnp.asarray(ins["q"])
    B, L, HD = q.shape
    D = HD // H
    hpb = 128 // D
    lane = hpb * D
    G = ins["gk"].shape[1]
    blk = lambda b, hp: (b, 0, hp)
    row = lambda b, hp: (b, 0, 0)
    call = pl.pallas_call(
        ref.make_kernel(variant, block_q, W, L // block_q, hpb, D, G),
        grid=(B, H // hpb),
        in_specs=[
            pl.BlockSpec((1, L, lane), blk),
            pl.BlockSpec((1, L + W, lane), blk),
            pl.BlockSpec((1, L + W, lane), blk),
            pl.BlockSpec((1, L + W, 1), row),
            pl.BlockSpec((1, G, lane), blk),
            pl.BlockSpec((1, G, lane), blk),
            pl.BlockSpec((1, 1, G), row),
        ],
        out_specs=pl.BlockSpec((1, L, lane), blk),
        out_shape=jax.ShapeDtypeStruct((B, L, HD), q.dtype),
        interpret=True,
    )
    args = [jnp.asarray(ins[k]) for k in ("q", "kpad", "vpad", "keyloc", "gk", "gv", "gvalid")]
    return np.asarray(call(*args).astype(jnp.float32))


def headpair_inputs(seed, B, L, P, dtype):
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal((B, L, P * 128)) * 0.3).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in out]
    return out


def headpair_pallas(ref, q, k, v, variant, block_q, W):
    B, L, C = q.shape
    blk = lambda b, hp: (b, 0, hp)
    call = pl.pallas_call(
        ref.make_kernel(variant, block_q, W, L // block_q, 64, L),
        grid=(B, C // 128),
        in_specs=[pl.BlockSpec((1, L, 128), blk)] * 3,
        out_specs=pl.BlockSpec((1, L, 128), blk),
        out_shape=jax.ShapeDtypeStruct((B, L, C), jnp.asarray(q).dtype),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)).astype(jnp.float32))


def torch_of(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32) if a.dtype != np.int32 else a)
    return t.to(getattr(torch, dtype)) if a.dtype != np.int32 else t


def rel_err(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# (L, W, G, block_q, dtype, keyloc zeros, invalid globals); B = 2, H = 4, D = 64
ABLATION_CASES = [
    (64, 64, 1, 16, "float32", (), ()),
    (256, 64, 2, 64, "float32", (5, 6, 7, 100, 101), ((1, 0),)),
    (256, 32, 1, 128, "bfloat16", (40, 41, 200), ()),
    (256, 64, 2, 16, "bfloat16", (3, 130, 131, 132), ((0, 0), (0, 1))),
]


@pytest.mark.parametrize("variant", bp.ABLATION_VARIANTS)
@pytest.mark.parametrize("case", ABLATION_CASES, ids=lambda c: f"L{c[0]}W{c[1]}G{c[2]}bq{c[3]}{c[4][0]}")
def test_ablation_plain_matches_pallas(ablation_ref, variant, case):
    L, W, G, bq, dtype, zero_keys, gvalid_zero = case
    H = 4
    ins = ablation_inputs(L + bq, 2, L, H, W, G, dtype, zero_keys, gvalid_zero)
    ref = ablation_pallas(ablation_ref, ins, variant, bq, W, H)
    out = bp.band_ablation(*(torch_of(ins[k], dtype) for k in (
        "q", "kpad", "vpad", "keyloc", "gk", "gv", "gvalid")),
        variant=variant, block_q=bq, window=W, num_heads=H)
    assert out.dtype == getattr(torch, dtype) and out.shape == ins["q"].shape
    assert np.isfinite(ref).all()
    assert rel_err(out.float().numpy(), ref) <= TOL[dtype], variant


# (L, W, block_q, dtype); B = 2, 2 head pairs
HEADPAIR_CASES = [
    (64, 64, 16, "float32"),
    (256, 64, 64, "float32"),
    (256, 32, 128, "bfloat16"),
    (256, 64, 16, "bfloat16"),
]


@pytest.mark.parametrize("variant", bp.HEADPAIR_VARIANTS)
@pytest.mark.parametrize("case", HEADPAIR_CASES, ids=lambda c: f"L{c[0]}W{c[1]}bq{c[2]}{c[3][0]}")
def test_headpair_plain_matches_pallas(headpair_ref, variant, case):
    L, W, bq, dtype = case
    q, k, v = headpair_inputs(L + W + bq, 2, L, 2, dtype)
    ref = headpair_pallas(headpair_ref, q, k, v, variant, bq, W)
    out = bp.band_headpair(*(torch_of(a, dtype) for a in (q, k, v)), variant=variant,
                           block_q=bq, window=W)
    assert out.dtype == getattr(torch, dtype)
    assert rel_err(out.float().numpy(), ref) <= TOL[dtype], variant


def test_headpair_pair_and_perhead_share_one_plain_version(headpair_ref):
    """In ``pair`` the cross-head terms multiply exact zeros: both reference
    kernels agree with each other and with the one plain version, whose two
    variant names give the same output; at L = 256 with block_q 64 the first
    and last blocks shift their window (offsets clamped)."""
    L, W, bq = 256, 64, 64
    band, offs = bp.headpair_offsets(L, bq, W)
    assert band == 128 and offs[0] == 0 and offs[-1] == L - band and offs[1] == bq - W // 2
    q, k, v = headpair_inputs(11, 2, L, 2, "float32")
    per = headpair_pallas(headpair_ref, q, k, v, "perhead", bq, W)
    pair = headpair_pallas(headpair_ref, q, k, v, "pair", bq, W)
    assert rel_err(pair, per) <= 1e-5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    outs = [bp.band_headpair(tq, tk, tv, variant=var, block_q=bq, window=W)
            for var in bp.HEADPAIR_VARIANTS]
    assert torch.equal(outs[0], outs[1])
    assert rel_err(outs[1].numpy(), per) <= 1e-5


def test_band_softmax_is_windowed_attention_at_every_block_q():
    """band_softmax and full keep only the window, which every band holds:
    the same output at block_q 16, 64 and 128; band_softmax equals a dense,
    unscaled softmax attention over ``|i - j| <= W/2`` and valid keys, with
    no global key. (Every row keeps a valid key here; a row with none would
    average its whole band.)"""
    B, L, H, W, G = 2, 256, 4, 64, 2
    half = W // 2
    ins = ablation_inputs(3, B, L, H, W, G, "float32", zero_keys=(10, 11, 12, 90),
                          gvalid_zero=((1, 1),))
    t = {k: torch_of(a, "float32") for k, a in ins.items()}
    outs = {var: [bp.band_ablation(**t, variant=var, block_q=bq, window=W, num_heads=H)
                  for bq in (16, 64, 128)] for var in ("band_softmax", "full")}
    for var, (a, b, c) in outs.items():
        assert rel_err(a.numpy(), b.numpy()) <= 1e-6, var
        assert rel_err(a.numpy(), c.numpy()) <= 1e-6, var
    # the dense reference, written out over the unpadded sequence
    q = ins["q"].reshape(B, L, H, 64).astype(np.float64)
    k = ins["kpad"][:, half:half + L].reshape(B, L, H, 64).astype(np.float64)
    v = ins["vpad"][:, half:half + L].reshape(B, L, H, 64).astype(np.float64)
    valid = ins["keyloc"][:, half:half + L, 0] != 0
    i, j = np.arange(L)[:, None], np.arange(L)[None, :]
    allowed = (np.abs(i - j) <= half)[None, None] & valid[:, None, None, :]  # (B, 1, L, L)
    s = np.einsum("bihd,bjhd->bhij", q, k)
    s = np.where(allowed, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dense = np.einsum("bhij,bjhd->bihd", p, v).reshape(B, L, H * 64)
    assert rel_err(outs["band_softmax"][0].numpy(), dense) <= 1e-5
    # the global scores change the result where a valid global key exists
    assert rel_err(outs["full"][0].numpy(), dense) > 1e-3


def test_kernels_refuse_what_they_do_not_take():
    """On CUDA tensors the wrappers launch or raise; the shape and type checks
    come first, so they are reachable without a card through the launchers."""
    ins = ablation_inputs(0, 1, 64, 2, 64, 1, "float32")
    t = {k: torch_of(a, "float32") for k, a in ins.items()}
    with pytest.raises(TypeError):  # float32: the kernels take bf16 only
        bp._launch_ablation(**t, variant="full", block_q=16, window=64, num_heads=2)
    tb = {k: (a.bfloat16() if a.is_floating_point() else a) for k, a in t.items()}
    with pytest.raises(ValueError):  # block_q not a multiple of 16
        bp._launch_ablation(**tb, variant="full", block_q=8, window=64, num_heads=2)
    with pytest.raises(ValueError):  # head_dim 32
        bp._launch_ablation(**tb, variant="full", block_q=16, window=64, num_heads=4)
    with pytest.raises(ValueError):
        bp.band_ablation(**tb, variant="softmax_only", block_q=16, window=64, num_heads=2)
    q = torch.zeros(1, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # block_q does not divide L
        bp._launch_headpair(q, q, q, "pair", 48, 64)
    with pytest.raises(TypeError):
        bp._launch_headpair(q.float(), q.float(), q.float(), "pair", 16, 64)


# ---------------------------------------------------------------------------
# the CUDA kernels' tile plan (csrc/band_probes.cu), emulated in PyTorch
# ---------------------------------------------------------------------------

CHUNK = 64  # band rows a stage; query rows a warpgroup (wgmma M)


def tile_plan(q, k, v, *, block_q, band, shift, maxoff, tile_rows, keyloc=None, window=None,
              softmax=False, gscores=None):
    """The kernels' arithmetic as they schedule it. q: (B, L, n, D); k, v:
    (B, R, n, D) band rows; query block i's band is ``band`` rows from
    ``clamp(i*block_q - shift, 0, maxoff)``. A block tile of ``tile_rows``
    query rows stages the union of its query blocks' bands in chunks of 64
    rows from the first block's band start (rows past R read as zeros); a
    warpgroup's 64 rows take the chunks that meet the union of their own
    blocks' bands, and each row leaves out the columns of other blocks'
    bands: zero for the plain products, -inf (out of the max and the sum)
    for the softmax, whose max starts at -1e30 and whose sum and output are
    rescaled chunk by chunk. ``keyloc`` (B, R) bool and ``window`` give the
    ablation's mask (-1e30); a chunk in every row's band and outside every
    row's window takes no product (each score is -1e30). ``gscores`` (B, L,
    n, G), already masked, join the max and the sum. Returns (B, L, n, D)."""
    B, L, n, D = q.shape
    R = k.shape[1]
    start = lambda i: min(max(i * block_q - shift, 0), maxoff)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, CHUNK))
    k, v = pad(k), pad(v)
    kl = None if keyloc is None else torch.nn.functional.pad(keyloc, (0, CHUNK))
    out = torch.zeros_like(q)
    for t0 in range(0, L, tile_rows):
        c0 = start(t0 // block_q)
        c1 = start((min(t0 + tile_rows, L) - 1) // block_q) + band
        for r0 in range(t0, min(t0 + tile_rows, L), CHUNK):
            rows = torch.arange(r0, min(r0 + CHUNK, L))
            last = int(rows[-1])
            lo, hi = start(r0 // block_q), start(last // block_q) + band
            own = torch.tensor([start(int(t) // block_q) for t in rows])[:, None]
            m = torch.full((B, n, len(rows), 1), -1e30, dtype=q.dtype)
            l = torch.zeros_like(m)
            o = torch.zeros(B, n, len(rows), D, dtype=q.dtype)
            qr = q[:, rows]
            if gscores is not None:
                g = gscores[:, rows].permute(0, 2, 1, 3)
                m = torch.maximum(m, g.amax(-1, keepdim=True))
                l = torch.exp(g - m).sum(-1, keepdim=True)
            for c in range(c0, c1, CHUNK):
                if not (c < hi and c + CHUNK > lo):
                    continue
                cols = torch.arange(c, c + CHUNK)[None, :]
                all_own = c >= start(last // block_q) and c + CHUNK <= lo + band
                if keyloc is not None and all_own and (c + CHUNK <= r0 or c > last + window):
                    s = torch.full((B, n, len(rows), CHUNK), bp.NEG_INF, dtype=q.dtype)
                else:
                    s = torch.einsum("bthd,buhd->bhtu", qr, k[:, c:c + CHUNK])
                    if keyloc is not None:
                        ok = ((cols - rows[:, None]) >= 0) & ((cols - rows[:, None]) <= window)
                        ok = ok[None] & kl[:, c:c + CHUNK][:, None, :]
                        s = torch.where(ok[:, None], s, bp.NEG_INF)
                mine = ((cols - own) >= 0) & ((cols - own) < band)
                if softmax:
                    s = torch.where(mine, s, -torch.inf)
                    mn = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp(m - mn)
                    e = torch.exp(s - mn)
                    l = l * alpha + e.sum(-1, keepdim=True)
                    o = o * alpha
                    m = mn
                else:
                    e = torch.where(mine, s, torch.zeros((), dtype=s.dtype))
                o = o + torch.einsum("bhtu,buhd->bhtd", e, v[:, c:c + CHUNK])
            if softmax:
                o = o / l.clamp_min(1e-30)
            out[:, rows] = o.permute(0, 2, 1, 3)
    return out


def ablation_tile_plan(ins, variant, block_q, W, H):
    """The ablation kernel's plan on the reference's inputs (numpy), float64."""
    t = {name: torch.from_numpy(np.asarray(a, np.float64 if a.dtype != np.int32 else np.int32))
         for name, a in ins.items()}
    B, L, HD = t["q"].shape
    G = t["gk"].shape[1]
    heads = lambda x: x.reshape(x.shape[0], x.shape[1], H, HD // H)
    masked = variant in ("no_softmax", "band_softmax", "full")
    gscores = None
    if variant == "full":
        gs = torch.einsum("bthd,bghd->bthg", heads(t["q"]), heads(t["gk"]))
        gscores = torch.where(t["gvalid"].reshape(B, 1, 1, G) != 0, gs, bp.NEG_INF)
    out = tile_plan(heads(t["q"]), heads(t["kpad"]), heads(t["vpad"]), block_q=block_q,
                    band=block_q + W, shift=0, maxoff=L - block_q, tile_rows=256,
                    keyloc=t["keyloc"].reshape(B, L + W) != 0 if masked else None, window=W,
                    softmax=variant in ("no_mask", "band_softmax", "full"), gscores=gscores)
    return out.reshape(B, L, HD)


# block_q -> L (a multiple of block_q; 480 leaves a last block tile of 224 rows)
PLAN_LENGTHS = {16: 480, 48: 480, 64: 512, 256: 512}


@pytest.mark.parametrize("G", (1, 8))
@pytest.mark.parametrize("block_q", sorted(PLAN_LENGTHS))
@pytest.mark.parametrize("variant", bp.ABLATION_VARIANTS)
def test_tile_plan_matches_ablation_plain(variant, block_q, G):
    """The kernel's plan (64-row warpgroups over the union band, other
    blocks' columns left out, online softmax) equals the plain version in
    float64, also on rows with no valid key (keys 0..69 and 200..299 off)
    and, in batch 1, no valid global either: such a row averages its own
    block's band and nothing else."""
    L, H, W = PLAN_LENGTHS[block_q], 2, 64
    ins = ablation_inputs(block_q + G, 2, L, H, W, G, "float32",
                          zero_keys=(*range(70), *range(200, 300)),
                          gvalid_zero=tuple((1, g) for g in range(G)))
    plan = ablation_tile_plan(ins, variant, block_q, W, H)
    t = {name: torch.from_numpy(np.asarray(a, np.float64 if a.dtype != np.int32 else np.int32))
         for name, a in ins.items()}
    ref = bp.band_ablation_plain(**t, variant=variant, block_q=block_q, window=W, num_heads=H)
    assert ref.dtype == torch.float64 and torch.isfinite(ref).all()
    assert rel_err(plan.numpy(), ref.numpy()) <= 1e-12, variant
    # the rows with nothing valid, alone (batch 1, keys 200..299 off)
    assert rel_err(plan[1, 240:260].numpy(), ref[1, 240:260].numpy()) <= 1e-12


@pytest.mark.parametrize("block_q", sorted(PLAN_LENGTHS))
@pytest.mark.parametrize("variant", bp.HEADPAIR_VARIANTS)
def test_tile_plan_matches_headpair_plain(variant, block_q):
    """The head-pair kernels' plan (128-row block tiles, 64-row warpgroups,
    the union of the clamped bands) equals the one plain version in float64;
    ``perhead`` and ``pair`` differ in staging only, so one plan serves both."""
    L, W, P = PLAN_LENGTHS[block_q], 64, 2
    q, k, v = (torch.from_numpy(a.astype(np.float64))
               for a in headpair_inputs(block_q, 2, L, P, "float32"))
    band, offs = bp.headpair_offsets(L, block_q, W)
    heads = lambda x: x.reshape(2, L, 2 * P, 64)
    plan = tile_plan(heads(q), heads(k), heads(v), block_q=block_q, band=band, shift=W // 2,
                     maxoff=L - band, tile_rows=128).reshape(2, L, P * 128)
    ref = bp.band_headpair_plain(q, k, v, variant=variant, block_q=block_q, window=W)
    assert offs[-1] == L - band
    assert rel_err(plan.numpy(), ref.numpy()) <= 1e-12
