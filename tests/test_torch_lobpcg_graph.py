"""The device LOBPCG's step as CUDA graph replays on the card
(``core/device_solver.py::_StepGraphs``), marked ``gpu``: they skip where
torch finds no card.  On a small girder pencil (K and M in ELL, f32,
m = 16, a Chebyshev preconditioner), a small 3-D Laplacian (DIA) and the
girder in BSR tiles: the graphed solve equals the eager one bit for bit;
a second call captures nothing and replays every piece; flipping TF32
captures anew; the launch counters of a graphed solve equal an eager
solve's; dropping the matrix drops the graphs.

This file imports nothing of JAX, so it runs on the card with
``--noconftest``."""

import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raleigh_tpu_torch.algebra.sparse import Chebyshev, spectral_bounds
from raleigh_tpu_torch.core import device_solver as ds
from raleigh_tpu_torch.core.device_solver import lobpcg
from raleigh_tpu_torch.examples import fe_model as fe
from raleigh_tpu_torch.examples.laplace import lap3d
from raleigh_tpu_torch.ops.spmm import (BsrMatrix, DiaMatrix, EllMatrix,
                                        device_sparse)

M = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


def _problem(case):
    """The operators, preconditioner and arguments of a solve of the six
    smallest pairs at m = 16 from a fixed start block."""
    if case == 'dia':
        a = lap3d(16, 16, 18, 1.0, 1.0, 1.0)
        lo, hi = spectral_bounds(a)
        ch = Chebyshev(a, lo, hi, degree=8)
        op, op_b = ch.device_matrix(), None
        assert isinstance(op, DiaMatrix)
    else:
        k, mass = fe.fe_pencil(9, 3, 0.1, seed=2, relabel=case == 'ell')
        lo, hi = spectral_bounds(k)
        if case == 'ell':
            ch = Chebyshev(k, hi * 1e-4, hi, degree=16)
            op, op_b = ch.device_matrix(), EllMatrix(mass)
            assert isinstance(op, EllMatrix)
        else:
            op, op_b = BsrMatrix(k, bs=32), BsrMatrix(mass, bs=32)
            ch = Chebyshev(k, hi * 1e-4, hi, degree=16, device_matrix=op)
    n = op.shape[0]
    x0 = np.random.RandomState(0).standard_normal((n, M))
    kw = dict(opB=op_b, precond=ch.device_rows_operands(M, n),
              block_size=M, tol=1e-4, maxit=200, x0=x0)
    return SimpleNamespace(op=op, ch=ch, kw=kw)


def _solve(pb):
    """(lobpcg's answer, GRAPH_COUNTS' change, the launch counters'
    change) of one solve."""
    counts = dict(ds.GRAPH_COUNTS)
    launches = [dict(c) for c in ds._LAUNCH_COUNTERS]
    out = lobpcg(pb.op, 6, **pb.kw)
    torch.cuda.synchronize()
    counted = {k: v - counts[k] for k, v in ds.GRAPH_COUNTS.items()}
    launched = [{k: c[k] - was.get(k, 0) for k in c
                  if c[k] != was.get(k, 0)}
                for c, was in zip(ds._LAUNCH_COUNTERS, launches)]
    return out, counted, launched


def _eager(pb, monkeypatch):
    with monkeypatch.context() as patch:
        patch.setattr(ds, '_graphable', lambda *args: False)
        return _solve(pb)


def _same(got, want):
    assert got[3:] == want[3:]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['ell', 'dia', 'bsr'])
def test_graphed_solve_is_the_eager_solve(cuda, case, monkeypatch):
    """Eigenvalues, vectors, residuals, iterations and status of the
    first graphed call (one eager iteration, a capture, replays) and of a
    second (replays only) equal the eager solve's bit for bit."""
    pb = _problem(case)
    want, counts, _ = _eager(pb, monkeypatch)
    it = want[3]
    assert want[4] == 0 and counts['captures'] == counts['replays'] == 0
    assert counts['eager_pieces'] == 4 * it
    first, counts, _ = _solve(pb)
    _same(first, want)
    assert counts == dict(captures=4, replays=4 * (it - 1), eager_pieces=4)
    second, _, _ = _solve(pb)
    _same(second, want)


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['ell', 'dia'])
def test_a_second_call_replays_every_piece(cuda, case):
    pb = _problem(case)
    out, _, _ = _solve(pb)
    again, counts, _ = _solve(pb)
    assert again[3] == out[3]
    assert counts == dict(captures=0, replays=4 * out[3], eager_pieces=0)


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['ell', 'dia'])
def test_launch_counters_count_every_replay(cuda, case, monkeypatch):
    """The kernels' launch counters after a graphed call, the capturing
    one and a replaying one, equal an eager solve's."""
    pb = _problem(case)
    want, _, eager = _eager(pb, monkeypatch)
    assert any(eager)
    for _ in range(2):
        got, _, launched = _solve(pb)
        assert got[3] == want[3] and launched == eager


@pytest.mark.gpu
def test_flipping_tf32_captures_anew(cuda):
    pb = _problem('ell')
    _solve(pb)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not tf32
    try:
        out, counts, _ = _solve(pb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert counts == dict(captures=4, replays=4 * (out[3] - 1),
                          eager_pieces=4)
    _, counts, _ = _solve(pb)
    assert counts['captures'] == 0 and counts['eager_pieces'] == 0


@pytest.mark.gpu
def test_dropping_the_matrix_drops_its_graphs(cuda):
    a = lap3d(16, 16, 18, 1.0, 1.0, 1.0)
    dm = device_sparse(a)
    x0 = np.random.RandomState(0).standard_normal((a.shape[0], M))
    entries = len(ds._GRAPHS)
    for _ in range(2):
        _, _, _, it, st = lobpcg(dm, 6, block_size=M, tol=1e-4, maxit=200,
                                 x0=x0)
        assert st == 0 and len(ds._GRAPHS) == entries + 1
    del dm
    gc.collect()
    assert len(ds._GRAPHS) == entries
