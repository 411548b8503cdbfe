"""The PyTorch port's DIA SpMM (raleigh_tpu_torch/ops) against the JAX
package and SciPy, on the CPU, where the wrapper takes the kernel's plain
PyTorch version.  The CUDA kernel itself is held against that plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances, relative to the largest |entry| of the reference: f32 1e-6
(f32 accumulation of 7 terms, rounding order differs between the
packages); bf16 2e-2 (one bf16 rounding of the output, as
tests/test_device_solver.py holds the JAX window kernel).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raleigh_tpu.examples.laplace import lap3d
from raleigh_tpu.ops.spmm import DiaMatrix as JaxDia, _dia_matmat_rows
from raleigh_tpu.ops.spmm_window import build_dia_window_ring
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.algebra.sparse import Operator, SparseSymmetricMatrix
from raleigh_tpu_torch.ops.spmm import (DiaMatrix, device_sparse,
                                        rows_matmat_operands)

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

TOL = {'float32': 1e-6, 'bfloat16': 2e-2}


@pytest.fixture(scope='module')
def lap():
    # n = 1024: lane-aligned, so the JAX window kernel runs at tile 256
    a = lap3d(8, 8, 16, 1.0, 1.0, 1.0)
    x = np.random.RandomState(0).randn(8, a.shape[0]).astype(np.float32)
    return a, x


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_reference(kind, a, x, dt):
    jd = JaxDia(a)
    xj = jnp.asarray(x).astype(dt)
    if kind == 'jax_fused':
        y = _dia_matmat_rows(jd.val, xj, jd.offsets)
    elif kind == 'jax_window_interpret':
        fn = build_dia_window_ring(jd.offsets, np.asarray(jd.val),
                                   a.shape[0], x.shape[0], tile=256,
                                   interpret=True, operand_dtype=dt)
        y = fn(xj)
    else:
        # SciPy on the operand as the port sees it (bf16-rounded)
        xr = np.asarray(xj.astype(jnp.float32), dtype=np.float64)
        return (a @ xr.T).T
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('reference', ['jax_fused', 'jax_window_interpret',
                                       'scipy'])
def test_dia_rows_matches_references(lap, reference, dtype):
    a, x = lap
    dm = DiaMatrix(a, dtype=np.float32, device='cpu')
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y = dm.matmat_rows(xt)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    want = _jax_reference(reference, a, x, getattr(jnp, dtype))
    assert _rel(y.float().numpy(), want) < TOL[dtype]


def test_from_arrays_reproduces_jax_matrix(lap):
    """State carried across: the JAX DiaMatrix's offsets and values build
    the port's matrix, whose product is the JAX matrix's."""
    a, x = lap
    jd = JaxDia(a)
    dm = DiaMatrix.from_arrays(jd.offsets, np.asarray(jd.val), device='cpu')
    assert dm.offsets == jd.offsets and dm.shape == jd.shape
    assert dm.val.dtype == torch.float32
    want = np.asarray(jd.matmat_rows(jnp.asarray(x)))
    got = dm.matmat_rows(torch.from_numpy(x))
    assert _rel(got.numpy(), want) < TOL['float32']
    fn, ops = rows_matmat_operands(dm)
    assert torch.equal(fn(ops, torch.from_numpy(x)), got)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_unaligned_n_and_m12(dtype):
    """No Mosaic limits: n = 693 (not a multiple of 128), m = 12."""
    a = lap3d(7, 9, 11, 1.0, 1.0, 1.0)
    x = np.random.RandomState(1).randn(12, a.shape[0]).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y = DiaMatrix(a, device='cpu').matmat_rows(xt)
    want = (a @ xt.float().numpy().astype(np.float64).T).T
    assert _rel(y.float().numpy(), want) < TOL[dtype]


def test_f64_matrix_and_column_layout(lap, monkeypatch):
    """An f64 matrix keeps f64 values while float64 is torch's default
    (as jnp.asarray does with x64 on) and drops to f32 otherwise; the
    column-layout apply is the row apply transposed."""
    a, x = lap
    x64 = np.random.RandomState(2).randn(a.shape[0], 5)
    monkeypatch.setattr(torch, 'get_default_dtype', lambda: torch.float64)
    d64 = DiaMatrix(a, dtype=np.float64, device='cpu')
    assert d64.val.dtype == torch.float64
    y = d64.matmat_t(torch.from_numpy(x64))
    assert _rel(y.numpy(), a @ x64) < 1e-13
    monkeypatch.setattr(torch, 'get_default_dtype', lambda: torch.float32)
    d32 = DiaMatrix(a, dtype=np.float64, device='cpu')
    assert d32.val.dtype == torch.float32


def test_device_sparse_steering():
    """A stencil goes to DIA; a scattered pattern, which raised before the
    ELL and BSR layouts were ported, now gets the layout the JAX package
    gives it."""
    import scipy.sparse as scs
    from raleigh_tpu.ops.spmm import device_sparse as jax_device_sparse
    a = lap3d(6, 6, 6, 1.0, 1.0, 1.0)
    assert isinstance(device_sparse(a, device='cpu'), DiaMatrix)
    b = scs.random(1500, 1500, density=0.01, random_state=3)
    b = b + b.T + scs.eye(1500)
    dm = device_sparse(b, device='cpu')
    assert type(dm).__name__ == 'EllMatrix'
    assert type(dm).__name__ == type(jax_device_sparse(b)).__name__


def test_wrapper_uses_plain_version_only_on_cpu(lap):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on another device is refused, never computed elsewhere."""
    a, x = lap
    dm = DiaMatrix(a, device='cpu')
    before = dict(sw.LAUNCHES)
    xt = torch.from_numpy(x)
    y = sw.dia_matmat_rows(dm.val, xt, dm.offsets_t)
    assert torch.equal(y, sw.dia_matmat_rows_plain(dm.val, xt,
                                                    dm.offsets_t))
    assert sw.LAUNCHES == before
    with pytest.raises(ValueError, match='device'):
        sw.dia_matmat_rows(dm.val, xt.to('meta'), dm.offsets_t)


def test_sparse_symmetric_matrix_and_operator(lap):
    """SparseSymmetricMatrix applies a tensor on its device matrix and an
    ndarray on the host CSR; Operator lets an ndarray-level operator take
    tensors."""
    a, x = lap
    x64 = x.astype(np.float64)
    sm = SparseSymmetricMatrix(a, device='cpu')
    host = np.empty_like(x64)
    sm.apply(x64, host)
    assert _rel(host, (a @ x64.T).T) < 1e-14
    dev = torch.empty(x.shape)
    sm.apply(torch.from_numpy(x), dev)
    assert _rel(dev.numpy(), host) < TOL['float32']
    y = torch.empty(x.shape, dtype=torch.float64)
    Operator(sm).apply(torch.from_numpy(x64), y)
    assert _rel(y.numpy(), host) < 1e-14
    with pytest.raises(ValueError, match='device matrix'):
        SparseSymmetricMatrix(a).apply(torch.from_numpy(x), dev)


@pytest.mark.parametrize('control', ['bf16 running sum', 'bf16 products'])
def test_chip_smoke_bf16_bound_rejects_bf16_accumulation(control):
    """chip_smoke.py holds the bf16 kernel to the plain version entrywise.
    An exact product rounded once to bf16 and the plain version summed in
    the reverse order meet the bound; the plain version done with a bf16
    running sum, or with bf16 products, does not."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    a = lap3d(7, 9, 11, 1.0, 1.0, 1.0)
    dm = DiaMatrix(a, device='cpu')
    x = torch.from_numpy(np.random.RandomState(4).randn(12, a.shape[0])
                         .astype(np.float32)).to(torch.bfloat16)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)

    def excess(got):
        return cs.bf16_excess(torch, sw, dm.val, x, dm.offsets_t, got,
                              want)[0]
    exact = (a @ x.float().numpy().astype(np.float64).T).T
    assert excess(torch.from_numpy(exact).to(torch.bfloat16)) <= 1
    rev = torch.from_numpy(np.flip(dm.offsets).copy()).to(torch.int32)
    reordered = sw.dia_matmat_rows_plain(dm.val.flip(0).contiguous(), x, rev)
    assert excess(reordered) <= 1
    bad = cs.bf16_controls(torch, dm.val, x, dm.offsets_t)[control]
    assert excess(bad) > 10
