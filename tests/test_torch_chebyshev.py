"""The PyTorch port's Chebyshev preconditioner against the JAX package's,
on the CPU (f64; float64 is torch's default dtype inside these tests)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.algebra.sparse import spectral_bounds
from raleigh_tpu.examples.laplace import lap3d
from raleigh_tpu_torch.algebra.sparse import Chebyshev

M = 8


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope='module')
def problem():
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    lo, hi = spectral_bounds(a)
    x = np.random.RandomState(0).standard_normal((M, a.shape[0]))
    return a, lo, hi, x


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _jax_apply(a, lo, hi, x, stream_bf16):
    ch = JaxChebyshev(a, lo, hi, degree=10, arch='tpu')
    fn, ops = ch.device_rows_operands(M, a.shape[0], dtype=x.dtype,
                                      stream_bf16=stream_bf16)
    return np.asarray(fn(ops, jnp.asarray(x)))


def test_rows_operands_match_jax_f64(problem, f64_default):
    """Same recurrence, same f64 arithmetic up to summation order:
    1e-10 relative."""
    a, lo, hi, x = problem
    ch = Chebyshev(a, lo, hi, degree=10, device='cpu')
    fn, ops = ch.device_rows_operands(M, a.shape[0], dtype=torch.float64)
    got = fn(ops, torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), _jax_apply(a, lo, hi, x, False)) < 1e-10


def test_bf16_route_matches_jax(problem):
    """bf16 iterates, f32 in and out: the two packages round at different
    places (XLA may keep excess precision between fused bf16 ops), so they
    agree to bf16 level, 2e-2; both stay within 5e-2 of the f32
    recurrence, a percent-level approximate inverse as it must be."""
    a, lo, hi, x = problem
    x32 = x.astype(np.float32)
    ch = Chebyshev(a, lo, hi, degree=10, device='cpu')
    fn, ops = ch.device_rows_operands(M, a.shape[0], stream_bf16=True)
    got = fn(ops, torch.from_numpy(x32))
    assert got.dtype == torch.float32
    want = _jax_apply(a, lo, hi, x32, True)
    assert _rel(got.numpy(), want) < 2e-2
    fn32, ops32 = ch.device_rows_operands(M, a.shape[0], stream_bf16=False)
    exact = fn32(ops32, torch.from_numpy(x32)).numpy()
    assert _rel(got.numpy(), exact) < 5e-2 and _rel(want, exact) < 5e-2


def test_auto_rule_flips_with_window_bytes(problem):
    """Auto routing: below WINDOW_HBM_BYTES the iterates stay f32; with
    the bound forced to zero on the device matrix instance, auto streams
    bf16 — bit for bit the explicit choices."""
    a, lo, hi, x = problem
    x32 = torch.from_numpy(x.astype(np.float32))
    n = a.shape[0]
    ch = Chebyshev(a, lo, hi, degree=10, device='cpu')

    def run(**kw):
        fn, ops = ch.device_rows_operands(M, n, **kw)
        return fn(ops, x32)
    off, on = run(stream_bf16=False), run(stream_bf16=True)
    assert not torch.equal(off, on)
    assert torch.equal(run(), off)
    dm = ch.device_matrix()
    dm.WINDOW_HBM_BYTES = 0          # instance override: fake HBM regime
    try:
        assert torch.equal(run(), on)
        # an f64 outer iteration never streams bf16
        fn, ops = ch.device_rows_operands(M, n, dtype=torch.float64)
        assert fn(ops, x32.double()).dtype == torch.float64
    finally:
        del dm.WINDOW_HBM_BYTES


def test_host_apply_matches_device_and_jax(problem, f64_default):
    """The ndarray apply (host CSR) and the tensor apply (device matrix)
    compute the same polynomial; both agree with the JAX host apply."""
    a, lo, hi, x = problem
    ch = Chebyshev(a, lo, hi, degree=10, device='cpu')
    yh = np.zeros_like(x)
    ch.apply(x, yh)
    yj = np.zeros_like(x)
    JaxChebyshev(a, lo, hi, degree=10, arch='cpu').apply(x, yj)
    assert _rel(yh, yj) < 1e-12
    yd = torch.zeros(x.shape, dtype=torch.float64)
    ch.apply(torch.from_numpy(x), yd)
    assert _rel(yd.numpy(), yh) < 1e-10
