"""The Gram of two row blocks (``ops/gram.py``, the kernel
``csrc/gram.cu``), which the device LOBPCG's ``_gram`` dispatches to.

On the CPU: the dispatch rule (which blocks go to the kernel: real f32
CUDA blocks at the instantiated widths, contiguous, n at or past the
crossover; CPU, f64, complex, bf16, other widths, short, strided and
sharded blocks to torch.matmul) on fake CUDA tensors, which no card
backs; the count of device Grams left to torch.matmul; the plain version
against a float64 product; an empty operand launching nothing; the
wrapper's checks before any launch.  Marked ``gpu`` (they skip where
torch finds no card): the kernel at (16, 16), (48, 48) and a self-Gram at
the LOBPCG cells' n against a float64 product, bit-equal across calls and
across a CUDA graph's replays, and a small LOBPCG under ``_StepGraphs``
with every non-empty Gram in the kernel.

This file imports nothing of JAX, so it runs on the card with
``--noconftest``."""

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from raleigh_tpu_torch.core import device_solver as ds
from raleigh_tpu_torch.ops import _build, gram
from raleigh_tpu_torch.parallel.mesh import (ShardedRows, blockvec_sharding,
                                             make_mesh)

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

N = gram.GRAM_MIN_N
U32 = 2.0 ** -24


def _blocks(ma, mb, n, dtype=torch.float32, seed=0, device='cpu'):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((ma, n), generator=g, dtype=torch.float64)
    b = torch.randn((mb, n), generator=g, dtype=torch.float64)
    return a.to(dtype).to(device), b.to(dtype).to(device)


# ---- the dispatch rule, on fake CUDA tensors ------------------------------

def _case(name):
    """(a, b) of the case ``name``, made inside a FakeTensorMode."""
    cuda = dict(device='cuda')
    f32 = dict(cuda, dtype=torch.float32)
    if name == 'f32 16x16':
        return torch.empty(16, N, **f32), torch.empty(16, N, **f32)
    if name == 'f32 48x48 long':
        return torch.empty(48, 1280000, **f32), torch.empty(48, 1280000,
                                                            **f32)
    if name == 'self 16':
        a = torch.empty(16, N, **f32)
        return a, a
    if name == 'short':
        return torch.empty(16, N - 1, **f32), torch.empty(16, N - 1, **f32)
    if name in ('f64', 'complex64', 'bfloat16'):
        dt = getattr(torch, name.replace('f64', 'float64'))
        return torch.empty(16, N, dtype=dt, **cuda), \
            torch.empty(16, N, dtype=dt, **cuda)
    if name in ('8x8', '16x48', '24x24'):
        ma, mb = map(int, name.split('x'))
        return torch.empty(ma, N, **f32), torch.empty(mb, N, **f32)
    if name == 'strided':
        return torch.empty(N, 16, **f32).T, torch.empty(16, N, **f32)
    if name == 'n differs':
        return torch.empty(16, N, **f32), torch.empty(16, N + 4, **f32)
    if name == 'cpu':
        return torch.empty(16, N), torch.empty(16, N)
    if name == 'cpu and cuda':
        return torch.empty(16, N), torch.empty(16, N, **f32)
    if name == '3-D':
        return torch.empty(1, 16, N, **f32), torch.empty(1, 16, N, **f32)
    raise KeyError(name)


KERNEL_CASES = ['f32 16x16', 'f32 48x48 long', 'self 16']
MATMUL_CASES = ['short', 'f64', 'complex64', 'bfloat16', '8x8', '16x48',
                '24x24', 'strided', 'n differs', 'cpu', 'cpu and cuda',
                '3-D']


@pytest.mark.parametrize('name', KERNEL_CASES + MATMUL_CASES)
def test_the_dispatch_rule(name):
    """Real f32 CUDA blocks at (16, 16) or (48, 48), contiguous, n at or
    past the crossover take the kernel; nothing else does."""
    with FakeTensorMode():
        a, b = _case(name)
        assert gram.takes_kernel(a, b) == (name in KERNEL_CASES)


def test_sharded_blocks_keep_their_own_gram():
    mesh = make_mesh(2, ['cpu'] * 2)
    a, b = _blocks(16, 16, 64)
    sa = ShardedRows.split(a, blockvec_sharding(mesh))
    sb = ShardedRows.split(b, blockvec_sharding(mesh))
    assert not gram.takes_kernel(sa, sb)
    assert torch.allclose(ds._gram(sa, sb), a @ b.T, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('name', KERNEL_CASES + ['f64', '24x24', 'short'])
def test_gram_sends_to_the_kernel_or_counts_a_matmul(name, monkeypatch):
    """``gram`` (as ``device_solver._gram`` calls it) hands the kernel's
    cases to ``gram_kernel`` and counts every other non-empty device Gram
    in ``MATMUL_GRAMS``; the kernel's are counted there by no one."""
    sent = []
    monkeypatch.setattr(gram, 'gram_kernel',
                        lambda a, b: sent.append(a is b) or a @ b.T)
    before = dict(gram.MATMUL_GRAMS)
    with FakeTensorMode():
        a, b = _case(name)
        g = ds._gram(a, b)
    assert tuple(g.shape) == (a.shape[0], b.shape[0])
    kernel = name in KERNEL_CASES
    assert sent == ([name == 'self 16'] if kernel else [])
    assert gram.MATMUL_GRAMS['device'] - before['device'] == (not kernel)


@pytest.mark.parametrize('rows', [(0, 16), (16, 0), (0, 0)])
def test_an_empty_operand_launches_nothing(rows, monkeypatch):
    """The constraint Grams against an empty ``y``: torch.matmul's empty
    product, no kernel launch, no library load, nothing counted."""
    monkeypatch.setattr(_build, 'library', lambda: pytest.fail('loaded'))
    launches = dict(gram.GRAM_LAUNCHES)
    before = dict(gram.MATMUL_GRAMS)
    with FakeTensorMode():
        a = torch.empty(rows[0], N, device='cuda')
        b = torch.empty(rows[1], N, device='cuda')
        assert not gram.takes_kernel(a, b)
        g = ds._gram(a, b)
    assert tuple(g.shape) == rows
    assert gram.GRAM_LAUNCHES == launches
    assert gram.MATMUL_GRAMS == before
    a, b = torch.empty(rows[0], 64), torch.empty(rows[1], 64)
    assert tuple(ds._gram(a, b).shape) == rows


@pytest.mark.parametrize('ma, mb, own', [(16, 16, False), (16, 16, True),
                                         (48, 48, False)])
def test_plain_version_against_a_float64_product(ma, mb, own):
    """On CPU tensors ``gram_kernel`` is the plain version.  Tolerance:
    an f32 sum of n products in any order is within n u sum_k |a_k b_k|
    of the exact (Higham, Accuracy and Stability, 3.1), u = 2^-24; the f64
    product's own error is 2^-29 times smaller."""
    n = 4099
    a, b = _blocks(ma, mb, n, seed=ma + own)
    if own:
        b = a
    got = gram.gram_kernel(a, b)
    assert got.dtype == torch.float32 and got.shape == (ma, mb)
    want = a.double() @ b.double().T
    terms = a.double().abs() @ b.double().abs().T
    assert torch.all((got.double() - want).abs() <= n * U32 * terms)
    assert torch.equal(got, gram.gram_plain(a, b))
    assert torch.equal(got, torch.matmul(a, b.T))


def test_the_cpu_route_counts_nothing(monkeypatch):
    """A CPU LOBPCG solve loads no kernel library and counts no Gram."""
    from raleigh_tpu_torch.examples.laplace import lap3d
    from raleigh_tpu_torch.ops.spmm import DiaMatrix
    monkeypatch.setattr(_build, 'library', lambda: pytest.fail('loaded'))
    launches, before = dict(gram.GRAM_LAUNCHES), dict(gram.MATMUL_GRAMS)
    a = lap3d(8, 8, 9, 1.0, 1.0, 1.0)
    x0 = np.random.RandomState(0).standard_normal((a.shape[0], 8))
    out = ds.lobpcg(DiaMatrix(a, device='cpu'), 3, block_size=8, x0=x0,
                    tol=1e-4, maxit=100)
    assert out[4] == 0
    assert gram.GRAM_LAUNCHES == launches and gram.MATMUL_GRAMS == before


@pytest.mark.parametrize('make, err, match', [
    (lambda: (torch.empty(16, N, device='cuda', dtype=torch.float64),) * 2,
     TypeError, 'real f32'),
    (lambda: (torch.empty(24, N, device='cuda'),
              torch.empty(24, N, device='cuda')), ValueError, 'widths'),
    (lambda: (torch.empty(16, N, device='cuda'),
              torch.empty(16, N + 1, device='cuda')), ValueError, 'shape'),
    (lambda: (torch.empty(N, 16, device='cuda').T,
              torch.empty(16, N, device='cuda')), ValueError, 'contiguous'),
    (lambda: (torch.empty(16, N, device='cuda'), torch.empty(16, N)),
     ValueError, 'share a device'),
], ids=['f64', 'width', 'n', 'strided', 'devices'])
def test_the_wrapper_refuses_before_any_launch(make, err, match,
                                               monkeypatch):
    monkeypatch.setattr(_build, 'library', lambda: pytest.fail('loaded'))
    with FakeTensorMode():
        a, b = make()
        with pytest.raises(err, match=match):
            gram.gram_kernel(a, b)


def test_the_counters_are_replayed_with_the_step_graphs():
    """A graph replay adds what its capture counted to the Gram counters
    too, so the counters of a graphed solve are an eager solve's."""
    assert gram.GRAM_LAUNCHES in ds._LAUNCH_COUNTERS
    assert gram.MATMUL_GRAMS in ds._LAUNCH_COUNTERS
    assert set(gram.GRAM_LAUNCHES) == {
        ('f32', ma, mb, own) for ma, mb in gram.WIDTHS
        for own in (False, True)}


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


def _rounding_chain(n, ma, mb, own):
    """The longest chain of f32 roundings behind one entry of the
    kernel's G: a lane's FMAs over its share of a block's chunk, the 4
    shuffles over the tile's 16 lanes, a slice of the sum kernel's 32
    and the 31 adds of the slices."""
    slots = gram.occupancy(ma, mb, own)['slots']
    chunk = -(-(-(-n // slots)) // 4) * 4
    blocks = -(-n // chunk)
    return -(-chunk // 16) + 4 + -(-blocks // 32) + 31


def _kernel_case(ma, own, n):
    a, b = _blocks(ma, ma, n, seed=n % 97 + ma, device='cuda')
    if own:
        b = a
    key = ('f32', ma, ma, own)
    before = gram.GRAM_LAUNCHES[key]
    got = gram.gram_kernel(a, b)
    again = gram.gram_kernel(a, b)
    torch.cuda.synchronize()
    assert gram.GRAM_LAUNCHES[key] == before + 2
    return a, b, got, again


@pytest.mark.gpu
@pytest.mark.parametrize('n', [1280000, 139179])
@pytest.mark.parametrize('ma, own', [(16, False), (16, True), (48, False)],
                         ids=['16x16', 'self16', '48x48'])
def test_the_kernel_against_a_float64_product(cuda, ma, own, n):
    """The Laplacian's and the finite-element pencil's n (odd: three rows
    in four off the 16-byte grid).  Tolerance entrywise: d u sum_k |a_k
    b_k| for the longest chain of d roundings in the kernel's summation
    tree (``_rounding_chain``; Higham, 4.2), u = 2^-24.  Bit-equal across
    two calls: the partial tiles are summed in a fixed order."""
    a, b, got, again = _kernel_case(ma, own, n)
    want = a.double() @ b.double().T
    terms = a.double().abs() @ b.double().abs().T
    d = _rounding_chain(n, ma, ma, own)
    assert torch.all((got.double() - want).abs() <= d * U32 * terms)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize('ma, own', [(16, False), (16, True), (48, False)],
                         ids=['16x16', 'self16', '48x48'])
def test_a_captured_gram_replays_the_eager_bits(cuda, ma, own):
    a, b, want, _ = _kernel_case(ma, own, 139179)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gram.gram_kernel(a, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gram.gram_kernel(a, b)
    for _ in range(2):
        out.fill_(float('nan'))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
def test_a_graphed_lobpcg_runs_every_gram_in_the_kernel(cuda, monkeypatch):
    """A 3-D Laplacian past the crossover (n = 64,000, DIA, a Chebyshev
    preconditioner, m = 16): under ``_StepGraphs`` every non-empty Gram
    runs in the kernel (none left to torch.matmul), the graphed solve
    equals the eager one bit for bit with the same counts, and its
    eigenvalues are the closed form's."""
    from raleigh_tpu_torch.algebra.sparse import Chebyshev, spectral_bounds
    from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
    grid = (40, 40, 40)
    a = lap3d(*grid, 1.0, 1.0, 1.0)
    n = a.shape[0]
    assert n >= gram.GRAM_MIN_N
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, lo, hi, degree=8)
    x0 = np.random.RandomState(0).standard_normal((n, 16))

    def solve():
        launches = [dict(c) for c in ds._LAUNCH_COUNTERS]
        out = ds.lobpcg(ch.device_matrix(), 4,
                        precond=ch.device_rows_operands(16, n),
                        block_size=16, tol=1e-5, maxit=200, x0=x0)
        torch.cuda.synchronize()
        return out, [{k: c[k] - was.get(k, 0) for k in c
                      if c[k] != was.get(k, 0)}
                     for c, was in zip(ds._LAUNCH_COUNTERS, launches)]

    with monkeypatch.context() as patch:
        patch.setattr(ds, '_graphable', lambda *args: False)
        eager, eager_counts = solve()
    launched = eager_counts[ds._LAUNCH_COUNTERS.index(gram.GRAM_LAUNCHES)]
    assert not eager_counts[ds._LAUNCH_COUNTERS.index(gram.MATMUL_GRAMS)]
    assert {k[1:] for k in launched} == {(16, 16, False), (16, 16, True),
                                         (48, 48, False)}
    for _ in range(2):
        got, counts = solve()
        assert counts == eager_counts
        assert got[3:] == eager[3:] and got[4] == 0
        for g, w in zip(got[:3], eager[:3]):
            assert np.array_equal(g, w)
    exact = np.sort(lap3d_eigenvalues(*grid, 1.0, 1.0, 1.0))[:4]
    assert np.allclose(np.sort(got[0]), exact, rtol=1e-4)
    assert math.isfinite(float(got[2].max()))
