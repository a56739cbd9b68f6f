"""The residual sum + LayerNorm op (``ops/add_layernorm.py``): on the CPU its
plain version against the chain of PyTorch ops ModernBERT ran before it
(bitwise), its dispatch, and its float32 gradient against autograd through
that chain.

The cases marked ``chip`` hold the CUDA kernel to the chain on a card and
skip without one: rows of 1,024 with a large common offset (which a
one-pass variance would lose), the sum bitwise, the output within one bf16
ulp, the gradients, a CUDA-graph replay and the counters. This file imports
no JAX, so they run there without the suite's conftest:

    python -m pytest --noconftest -m chip tests/test_torch_add_layernorm.py
"""

import pytest
import torch

from recformer_tpu_torch.ops import add_layernorm as aln
from recformer_tpu_torch.utils import profiling

EPS = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def chain(x, d, weight, eps):
    """The model's LayerNorm before the kernel, after the residual sum ``x + d``
    (none with ``d`` None), as plain PyTorch ops: ``(s, y)`` or ``y``."""
    s = x if d is None else x + d
    sf = s.float()
    xc = sf - sf.mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps) * weight.float()).to(s.dtype)
    return y if d is None else (s, y)


def inputs(shape, dtype, device="cpu", offset=0.0, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (offset + torch.randn(shape, generator=g, device=device)).to(dtype)
    d = torch.randn(shape, generator=g, device=device).to(dtype)
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
    return x, d, w


def launches() -> tuple:
    c = profiling.counters()
    return c.get("add_layernorm.launches", 0), c.get("add_layernorm.residual", 0)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_path_equals_the_chain_bitwise(dtype, residual):
    x, d, w = inputs((3, 7, 64), DTYPES[dtype], offset=4.0)
    d = d if residual else None
    got, want = as_tuple(aln.add_layernorm(x, d, w, EPS)), as_tuple(chain(x, d, w, EPS))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", ["unbuilt_width", "float16", "no_rows", "residual_elsewhere",
                                  "gamma_shape"])
def test_the_kernel_wrapper_refuses_what_the_kernel_is_not_built_for(case):
    """CUDA tensors launch the kernel or raise: ``_launch`` refuses an
    unbuilt width or type, no rows and operands elsewhere before it loads
    or launches anything (so CPU tensors show it here)."""
    x, d, w = inputs((4, 64), torch.bfloat16)
    error = ValueError
    if case == "unbuilt_width":
        x, d, w = inputs((4, 96), torch.bfloat16)
    elif case == "float16":
        x, d, error = x.half(), d.half(), TypeError
    elif case == "no_rows":
        x, d = x[:0], d[:0]
    elif case == "residual_elsewhere":
        d = d.to("meta")
    else:
        w = w[:32]
    before = launches()
    with pytest.raises(error):
        aln._launch(x, d, w, EPS)
    assert launches() == before


@pytest.mark.parametrize("width", [64, 96], ids=["built", "unbuilt"])
def test_cpu_tensors_take_the_plain_path_and_count_no_launch(width):
    x, d, w = inputs((5, width), torch.bfloat16)
    before = launches()
    s, y = aln.add_layernorm(x, d, w, EPS)
    aln.add_layernorm(x, None, w, EPS)
    assert launches() == before
    assert torch.equal(y, chain(x, d, w, EPS)[1])


def test_tensors_on_neither_cuda_nor_the_cpu_are_refused():
    x, d, w = (t.to("meta") for t in inputs((2, 64), torch.float32))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        aln.add_layernorm(x, d, w, EPS)


def test_a_residual_of_another_shape_or_type_is_refused():
    x, d, w = inputs((2, 64), torch.float32)
    for bad in (d[:1], d.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="residual"):
            aln.add_layernorm(x, bad, w, EPS)


def grads_of(fn, x, d, w, seed=1):
    """Gradients of ``x``, ``d`` (None without a residual) and ``w`` of a
    random linear function of the outputs, the sum's included."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, d, w) if t is not None]
    out = as_tuple(fn(leaves[0], leaves[1] if d is not None else None, leaves[-1], EPS))
    g = torch.Generator(device=x.device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g, device=x.device)).sum()
               for o in out)
    loss.backward()
    return [t.grad for t in leaves]


def assert_grads_close(got, want, tol):
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale, (a, b)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
def test_plain_backward_matches_autograd_through_the_chain(residual):
    x, d, w = inputs((4, 9, 128), torch.float32, offset=3.0)
    d = d if residual else None
    assert_grads_close(grads_of(aln.add_layernorm, x, d, w), grads_of(chain, x, d, w), 1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

OFFSET = 256.0  # a one-pass variance at 1,024 values near 256 of spread 1 loses ~2**-7
SHAPES = {"rows_4096": (4096, 1024), "rank_slice": (2, 8192, 1024)}
# float32 output, max abs: the row means of values near OFFSET, summed in
# another order, differ by a few float32 ulps of OFFSET
FP32_TOL = 5e-4
ULP_FLOOR = 2.0 ** -8  # bf16: one ulp of each reference element, no finer than here


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bf16_ulp(ref):
    _, e = torch.frexp(ref.float().abs().clamp_min(ULP_FLOOR))
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


@pytest.mark.chip
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_chip_kernel_matches_the_chain(card, shape, dtype, residual):
    x, d, w = inputs(SHAPES[shape], DTYPES[dtype], card, offset=OFFSET)
    d = d if residual else None
    with torch.no_grad():
        before = launches()
        got = as_tuple(aln.add_layernorm(x, d, w, EPS))
        after = launches()
        want = as_tuple(chain(x, d, w, EPS))
    assert (after[0] - before[0], after[1] - before[1]) == (1, int(residual))
    if residual:
        assert torch.equal(got[0], want[0])
    y, ref = got[-1].float(), want[-1].float()
    err = (y - ref).abs()
    if dtype == "bfloat16":
        assert bool((err <= bf16_ulp(ref)).all()), float(err.max())
    else:
        assert float(err.max()) <= FP32_TOL


@pytest.mark.chip
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_chip_gradients_match_autograd_through_the_chain(card, shape, residual):
    x, d, w = inputs(SHAPES[shape], torch.float32, card, offset=OFFSET)
    d = d if residual else None
    assert_grads_close(grads_of(aln.add_layernorm, x, d, w), grads_of(chain, x, d, w), 1e-5)


@pytest.mark.chip
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chip_replay_equals_eager_bitwise(card, dtype, residual):
    x, d, w = inputs(SHAPES["rows_4096"], DTYPES[dtype], card, offset=OFFSET)
    d = d if residual else None
    with torch.no_grad():
        want = as_tuple(aln.add_layernorm(x, d, w, EPS))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            aln.add_layernorm(x, d, w, EPS)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = as_tuple(aln.add_layernorm(x, d, w, EPS))
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want))
