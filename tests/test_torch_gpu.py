"""The CUDA DIA kernel against its plain PyTorch version on the card.

Marked ``gpu``: without a CUDA device every test here skips (the fixture
decides, so every pytest-xdist worker collects the same tests).  Run on a
machine with a card:  python -m pytest tests/test_torch_gpu.py
(add --noconftest where jax is not installed: tests/conftest.py imports
it).

Tolerances: f32, 1e-6 of the largest |entry| of the plain result (both
accumulate in f32); bf16, the entrywise bound of ``chip_smoke.bf16_excess``
(one bf16 rounding on either side plus the f32 summation error bound),
which a bf16 running sum or bf16 products fail.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from raleigh_tpu_torch.examples.laplace import lap3d
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.ops.spmm import DiaMatrix

pytestmark = pytest.mark.gpu

F32_TOL = 1e-6


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


def _banded(n, offsets, seed):
    """A DIA matrix with the given offsets and random values."""
    rng = np.random.RandomState(seed)
    val = rng.standard_normal((len(offsets), n)).astype(np.float32)
    return offsets, val


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(8, 8, 16, 8), (7, 9, 11, 12),
                                   (30, 30, 31, 3)])
def test_kernel_matches_plain(cuda, shape, dtype):
    """lap3d stencils: aligned n, unaligned n with m = 12, and m below
    the kernel's 8-row group."""
    nx, ny, nz, m = shape
    dm = DiaMatrix(lap3d(nx, ny, nz, 1.0, 1.0, 1.0), device=cuda)
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((m, dm.shape[0]), generator=g, device=cuda).to(dtype)
    before = sw.LAUNCHES[str(dtype).replace('torch.', '')]
    y = sw.dia_matmat_rows(dm.val, x, dm.offsets_t)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    if dtype == torch.float32:
        err = (y - want).abs().max() / want.abs().max()
        assert err.item() <= F32_TOL
    else:
        worst, _ = _chip_smoke().bf16_excess(torch, sw, dm.val, x,
                                             dm.offsets_t, y, want)
        assert worst <= 1
    assert sw.LAUNCHES[str(dtype).replace('torch.', '')] == before + 1


def test_kernel_many_offsets(cuda):
    """96 diagonals (device_sparse's DIA limit), offsets past either end
    of a short vector."""
    n = 1000
    offsets = sorted(set(range(-60, 61, 2)) | {-1500, -999, 999, 1500})
    offs, val = _banded(n, offsets[:96], 1)
    dm = DiaMatrix.from_arrays(offs, val, device=cuda)
    x = torch.randn((16, n), device=cuda)
    y = dm.matmat_rows(x)
    want = sw.dia_matmat_rows_plain(dm.val, x, dm.offsets_t)
    torch.cuda.synchronize()
    err = (y - want).abs().max() / want.abs().max()
    assert err.item() <= F32_TOL


def test_kernel_refuses_what_it_cannot_take(cuda):
    dm = DiaMatrix(lap3d(6, 6, 6, 1.0, 1.0, 1.0), device=cuda)
    x = torch.randn((8, dm.shape[0]), device=cuda)
    with pytest.raises(TypeError):
        sw.dia_matmat_rows(dm.val, x.double(), dm.offsets_t)
    with pytest.raises(ValueError, match='contiguous'):
        sw.dia_matmat_rows(dm.val, torch.randn((dm.shape[0], 8),
                                               device=cuda).T, dm.offsets_t)
    with pytest.raises(ValueError, match='shape'):
        sw.dia_matmat_rows(dm.val, x[:, :-1].contiguous(), dm.offsets_t)
    with pytest.raises(ValueError, match='device'):
        sw.dia_matmat_rows(dm.val.cpu(), x, dm.offsets_t)
