"""The Chebyshev recurrence's step as one launch on an ELL matrix
(``ops/spmm.py::_ell_step``, ``csrc/ell_spmm.cu``'s ``ell_step_kernel``).

On the CPU: the step's plain version equals the recurrence's eager step
bit for bit; a ``Chebyshev`` on an ``EllMatrix`` gives the same bits
through the step form as through the eager form; DIA, BSR, sharded ELL,
complex and bf16-stream recurrences keep the eager step; the checks
refuse what the kernel does not take.  Marked ``gpu`` (they skip where
torch finds no card): the kernel against the eager step (the ELL kernel
and the eager passes) and against the plain step at a small girder and at
the finite-element cells' shapes, the whole recurrence, a device LOBPCG
solve under CUDA graphs, and one apply captured and replayed.

This file imports nothing of JAX, so it runs on the card with
``--noconftest``."""

import numpy as np
import pytest
import torch

from raleigh_tpu_torch.algebra import sparse
from raleigh_tpu_torch.algebra.sparse import Chebyshev, spectral_bounds
from raleigh_tpu_torch.core import device_solver as ds
from raleigh_tpu_torch.core.device_solver import lobpcg, shard_operator
from raleigh_tpu_torch.examples import fe_model as fe
from raleigh_tpu_torch.examples.laplace import lap3d
from raleigh_tpu_torch.ops import _build, spmm
from raleigh_tpu_torch.ops.spmm import BsrMatrix, EllMatrix
from raleigh_tpu_torch.parallel.mesh import make_mesh

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

DTYPES = {'f32': torch.float32, 'f64': torch.float64}
NP_DTYPES = {'f32': np.float32, 'f64': np.float64}
PAIRS = [('f32', 'f32'), ('f32', 'f64'), ('f64', 'f64')]
# a step's place in the recurrence: (first, last)
PLACES = {'first': (True, False), 'middle': (False, False),
          'last': (False, True), 'only': (True, True)}
# the recurrence's coefficients at its second step, on [1e-4, 1]
THETA, DELTA = 0.5 * (1 + 1e-4), 0.5 * (1 - 1e-4)
C1, C2 = 0.8123456789012345, 1.2345678901234567


@pytest.fixture(scope='module')
def girder():
    """A small girder's stiffness with an odd n: the leading principal
    block of one row fewer."""
    k = fe.fe_pencil(6, 3, 0.1, seed=2, which='k')
    n = k.shape[0] - 1
    return k[:n, :n].tocsr()


def _matrix(k, values, device='cpu'):
    return EllMatrix(k, dtype=NP_DTYPES[values], device=device, exact=True)


def _iterates(n, m, dtype, device, seed):
    """(d, r, y) as (m, n) blocks, the eager recurrence's layout."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((m, n), generator=g, dtype=torch.float64)
                 .to(dtype).to(device) for _ in range(3))


def _eager_step(em, d, r, y, c1, c2, first, last):
    """The recurrence's own eager step (``sparse._eager_step``) on (m, n)
    blocks: (d', r', y'), None where the last step leaves it."""
    mat_fn, ops = spmm.rows_matmat_operands(em)
    d, r, y = sparse._eager_step(mat_fn, ops, d, r, None if first else y,
                                 c1, c2)
    return (None, None, y) if last else (d, r, y)


def _step(em, d, r, y, c1, c2, first, last, step=spmm._ell_step):
    """``step`` on the (n, m) transposes of (m, n) blocks: (d', r', y')
    transposed back, d' None and r' None on the last step."""
    dt, rt, yt = (t.T.contiguous() for t in (d, r, y))
    d_next = torch.full_like(dt, float('nan'))
    step(em.idx, em.val, dt, d_next, rt, yt, c1, c2, first, last)
    if last:
        return None, None, yt.T
    return d_next.T, rt.T, yt.T


def _same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize('place', list(PLACES))
@pytest.mark.parametrize('pair', PAIRS, ids='_'.join)
def test_plain_step_is_the_eager_step(girder, pair, place):
    em = _matrix(girder, pair[0])
    d, r, y = _iterates(girder.shape[0], 7, DTYPES[pair[1]], 'cpu', 1)
    first, last = PLACES[place]
    want = _eager_step(em, d, r, y, C1, C2, first, last)
    _same(_step(em, d, r, y, C1, C2, first, last), want)


def _forms(ch, x, monkeypatch):
    """(step form, eager form, (first, last) of each step of the first) of
    one apply of ``ch``'s recurrence to ``x``."""
    calls = []
    inner = spmm._ell_step

    def counted(*args):
        calls.append(args[8:])
        return inner(*args)
    with monkeypatch.context() as patch:
        patch.setattr(spmm, '_ell_step', counted)
        fn, ops = ch._recurrence(stream_bf16=False)
        got = fn(ops, x)
    with monkeypatch.context() as patch:
        patch.setattr(sparse, 'rows_step_operands', lambda *args: None)
        fn, ops = ch._recurrence(stream_bf16=False)
        want = fn(ops, x)
    return got, want, calls


@pytest.mark.parametrize('degree', [1, 2, 32])
@pytest.mark.parametrize('m', [1, 7, 16])
@pytest.mark.parametrize('pair', PAIRS, ids='_'.join)
def test_step_form_is_the_eager_form(girder, pair, m, degree, monkeypatch):
    """A ``Chebyshev`` on a CPU-resident ``EllMatrix``: the step form
    takes ``degree`` steps, the first and the last in their places, leaves
    its operand as it was and gives the eager form's bits."""
    lo, hi = spectral_bounds(girder)
    ch = Chebyshev(girder, hi * 1e-4, hi, degree=degree,
                   device_matrix=_matrix(girder, pair[0]))
    x = _iterates(girder.shape[0], m, DTYPES[pair[1]], 'cpu', m)[0]
    x0 = x.clone()
    got, want, calls = _forms(ch, x, monkeypatch)
    assert calls == [(i == 0, i == degree - 1) for i in range(degree)]
    assert torch.equal(x, x0)
    assert got.shape == x.shape and got.is_contiguous()
    _same((got,), (want,))


def _other(case):
    """(Chebyshev, operand, stream_bf16) of a recurrence that keeps the
    eager step."""
    k = fe.fe_pencil(6, 3, 0.1, seed=2, which='k')
    lo, hi = spectral_bounds(k)
    n = k.shape[0]
    x = torch.from_numpy(np.random.RandomState(3).standard_normal((8, n)))
    bf16 = False
    if case == 'dia':
        a = lap3d(8, 8, 9, 1.0, 1.0, 1.0)
        lo, hi = spectral_bounds(a)
        ch = Chebyshev(a, lo, hi, degree=4, device='cpu')
        assert type(ch.device_matrix()).__name__ == 'DiaMatrix'
        x = torch.from_numpy(
            np.random.RandomState(3).standard_normal((8, a.shape[0])))
    elif case == 'bsr':
        ch = Chebyshev(k, hi * 1e-4, hi, degree=4,
                       device_matrix=BsrMatrix(k, bs=32, device='cpu'))
    elif case == 'sharded':
        em = shard_operator(EllMatrix(k, device='cpu'),
                            make_mesh(2, ['cpu'] * 2))
        ch = Chebyshev(k, hi * 1e-4, hi, degree=4, device_matrix=em)
    else:
        ch = Chebyshev(k, hi * 1e-4, hi, degree=4,
                       device_matrix=EllMatrix(k, device='cpu'))
        if case == 'complex':
            x = torch.complex(x, x.flip(0)).to(torch.complex64)
        elif case == 'bf16':
            x, bf16 = x.float(), True
        else:   # f64 values with f32 iterates: no step instantiation
            ch = Chebyshev(k, hi * 1e-4, hi, degree=4,
                           device_matrix=EllMatrix(
                               k, dtype=np.float64, device='cpu',
                               exact=True))
            x = x.float()
    return ch, x, bf16


@pytest.mark.parametrize('case', ['dia', 'bsr', 'sharded', 'complex',
                                  'bf16', 'f64_values_f32_iterates'])
def test_other_recurrences_keep_the_eager_step(case, monkeypatch):
    ch, x, bf16 = _other(case)

    def refuse(*args, **kw):
        raise AssertionError('the step form ran')
    spmm.reset_launches()
    monkeypatch.setattr(spmm, '_ell_step', refuse)
    fn, ops = ch.device_rows_operands(x.shape[0], x.shape[1], dtype=x.dtype,
                                      stream_bf16=bf16)
    y = fn(ops, x)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(torch.view_as_real(y) if y.is_complex()
                               else y).all())
    assert not any(spmm.ELL_STEP_LAUNCHES.values())


def test_apply_takes_the_step_form(girder, monkeypatch):
    """``Chebyshev.apply`` on a tensor (the core Solver's route) goes
    through the step form and writes the eager form's bits."""
    lo, hi = spectral_bounds(girder)
    ch = Chebyshev(girder, hi * 1e-4, hi, degree=8,
                   device_matrix=_matrix(girder, 'f32'))
    x = _iterates(girder.shape[0], 8, torch.float64, 'cpu', 5)[0]
    calls = []
    inner = spmm._ell_step
    monkeypatch.setattr(spmm, '_ell_step',
                        lambda *a: calls.append(1) or inner(*a))
    y = torch.empty_like(x)
    ch.apply(x, y)
    assert len(calls) == 8
    monkeypatch.setattr(sparse, 'rows_step_operands', lambda *args: None)
    want = torch.empty_like(x)
    Chebyshev(girder, hi * 1e-4, hi, degree=8,
              device_matrix=_matrix(girder, 'f32')).apply(x, want)
    assert torch.equal(y, want)


def test_cpu_step_loads_no_library_and_counts_nothing(girder, monkeypatch):
    def no_library():
        raise AssertionError('the library was asked for')
    monkeypatch.setattr(_build, 'library', no_library)
    spmm.reset_launches()
    em = _matrix(girder, 'f32')
    d, r, y = _iterates(girder.shape[0], 4, torch.float32, 'cpu', 2)
    _step(em, d, r, y, C1, C2, False, False)
    assert set(spmm.ELL_STEP_LAUNCHES) == set(PAIRS)
    assert not any(spmm.ELL_STEP_LAUNCHES.values())
    spmm.ELL_STEP_LAUNCHES[('f32', 'f64')] += 1
    spmm.reset_launches()
    assert not any(spmm.ELL_STEP_LAUNCHES.values())
    assert any(c is spmm.ELL_STEP_LAUNCHES for c in ds._LAUNCH_COUNTERS)


def _buffers(girder):
    em = _matrix(girder, 'f32')
    n = girder.shape[0]
    return [em.idx, em.val] + [torch.zeros((n, 4)) for _ in range(4)]


def _replace(i, make):
    def bad(ts):
        ts = list(ts)
        ts[i] = make(ts[i])
        return ts
    return bad


# each refusal of _ell_step_check: (how the arguments are made wrong, the
# error, its message); CPU tensors pass every check but the device's
REFUSALS = {
    'cpu': (lambda ts: ts, ValueError, 'no Chebyshev step for device'),
    'bf16 iterates': (lambda ts: ts[:2] + [t.bfloat16() for t in ts[2:]],
                      TypeError, 'f32 values with f32 or f64'),
    'f64 values': (_replace(1, lambda t: t.double()), TypeError,
                   'f64 values with f64'),
    'int64 idx': (_replace(0, lambda t: t.long()), TypeError, 'int32 idx'),
    'mixed iterates': (_replace(4, lambda t: t.double()), TypeError,
                       'share a dtype'),
    'short val': (_replace(1, lambda t: t[:-1]), ValueError,
                  'shape mismatch'),
    'wide y': (_replace(5, lambda t: torch.zeros((t.shape[0], 5))),
               ValueError, 'shape mismatch'),
    'strided d': (_replace(2, lambda t: torch.zeros((4, t.shape[0])).T),
                  ValueError, 'contiguous'),
    'd_next is d': (lambda ts: ts[:3] + [ts[2]] + ts[4:], ValueError,
                    'four buffers'),
    'meta r': (_replace(4, lambda t: t.to('meta')), ValueError,
               'share a device'),
}


@pytest.mark.parametrize('case', list(REFUSALS))
def test_step_check_refuses(girder, case):
    make, err, match = REFUSALS[case]
    with pytest.raises(err, match=match):
        spmm._ell_step_check(*make(_buffers(girder)))


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; torch finds none')
    return torch.device('cuda')


def _random_ell(n, k, values, seed):
    """An ELL matrix at n rows of k entries with random columns and values
    on the card (the cells' shapes without building their pencil)."""
    g = torch.Generator('cuda').manual_seed(seed)
    idx = torch.randint(0, n, (n, k), generator=g, device='cuda',
                        dtype=torch.int32)
    val = torch.randn((n, k), generator=g, device='cuda',
                      dtype=DTYPES[values])
    return EllMatrix.from_arrays(idx.cpu().numpy(), val.cpu().numpy(),
                                 device='cuda')


def _kernel_cases(cuda, em, pair, m, place):
    before = dict(spmm.ELL_STEP_LAUNCHES)
    d, r, y = _iterates(em.shape[0], m, DTYPES[pair[1]], cuda, m)
    first, last = PLACES[place]
    got = _step(em, d, r, y, C1, C2, first, last)
    assert spmm.ELL_STEP_LAUNCHES[pair] == before[pair] + 1
    _same(got, _eager_step(em, d, r, y, C1, C2, first, last))
    _same(got, _step(em, d, r, y, C1, C2, first, last,
                     step=spmm._ell_step_plain))


@pytest.mark.gpu
@pytest.mark.parametrize('place', list(PLACES))
@pytest.mark.parametrize('m', [7, 8, 16])
@pytest.mark.parametrize('pair', PAIRS, ids='_'.join)
def test_kernel_is_the_eager_step(cuda, girder, pair, m, place):
    """A scaled-down girder (odd n), every pair at m = 7 (one value a
    lane), 8 and 16, every place of a step: the kernel equals the eager
    step (the ELL kernel and the eager passes) and the plain step bit for
    bit."""
    _kernel_cases(cuda, _matrix(girder, pair[0], cuda), pair, m, place)


@pytest.mark.gpu
@pytest.mark.parametrize('place', ['first', 'middle', 'last'])
@pytest.mark.parametrize('pair, m', [(('f32', 'f32'), 16),
                                     (('f32', 'f64'), 8)], ids=['lobpcg6',
                                                                'core6'])
def test_kernel_at_the_cells_shapes(cuda, pair, m, place):
    """n = 139,179 rows of 80 entries, as the finite-element cells' ELL
    matrix, at their block widths."""
    em = _random_ell(139179, 80, pair[0], 7)
    _kernel_cases(cuda, em, pair, m, place)


@pytest.mark.gpu
@pytest.mark.parametrize('m', [7, 8, 16])
@pytest.mark.parametrize('pair', PAIRS, ids='_'.join)
def test_recurrence_on_the_card_is_the_eager_recurrence(cuda, girder, pair,
                                                        m, monkeypatch):
    lo, hi = spectral_bounds(girder)
    ch = Chebyshev(girder, hi * 1e-4, hi, degree=32,
                   device_matrix=_matrix(girder, pair[0], cuda))
    x = _iterates(girder.shape[0], m, DTYPES[pair[1]], cuda, m)[0]
    spmm.reset_launches()
    checks = []
    check = spmm._ell_step_check
    monkeypatch.setattr(spmm, '_ell_step_check',
                        lambda *a: checks.append(1) or check(*a))
    got, want, calls = _forms(ch, x, monkeypatch)
    assert len(calls) == 32 and spmm.ELL_STEP_LAUNCHES[pair] == 32
    assert len(checks) == 1     # once an apply
    _same((got,), (want,))


def _solve(ch, m_ell, x0, m):
    """(lobpcg's answer, the launch counters' change) of one solve."""
    launches = [dict(c) for c in ds._LAUNCH_COUNTERS]
    out = lobpcg(ch.device_matrix(), 6, opB=m_ell,
                 precond=ch.device_rows_operands(m, x0.shape[0]),
                 block_size=m, tol=1e-4, maxit=200, x0=x0)
    torch.cuda.synchronize()
    return out, [{k: c[k] - was.get(k, 0) for k in c
                  if c[k] != was.get(k, 0)}
                 for c, was in zip(ds._LAUNCH_COUNTERS, launches)]


@pytest.mark.gpu
def test_graphed_solve_equals_the_eager_recurrence(cuda, monkeypatch):
    """A small girder pencil, K and M in ELL, f32, m = 16: the device
    LOBPCG with the step form under ``_StepGraphs`` gives the eigenvalues
    and vectors of the eager recurrence bit for bit, and every replay
    counts its step launches (a graphed call counts what an eager-pieces
    call counts)."""
    k, mass = fe.fe_pencil(9, 3, 0.1, seed=2)
    lo, hi = spectral_bounds(k)
    m_ell = EllMatrix(mass)
    x0 = np.random.RandomState(0).standard_normal((k.shape[0], 16))
    with monkeypatch.context() as patch:
        patch.setattr(sparse, 'rows_step_operands', lambda *args: None)
        eager_ch = Chebyshev(k, hi * 1e-4, hi, degree=16)
        want, _ = _solve(eager_ch, m_ell, x0, 16)
    ch = Chebyshev(k, hi * 1e-4, hi, degree=16)
    with monkeypatch.context() as patch:
        patch.setattr(ds, '_graphable', lambda *args: False)
        pieces, counted = _solve(ch, m_ell, x0, 16)
    steps = counted[ds._LAUNCH_COUNTERS.index(spmm.ELL_STEP_LAUNCHES)]
    assert steps[('f32', 'f32')] > 0
    replays = ds.GRAPH_COUNTS['replays']
    for _ in range(2):
        got, launched = _solve(ch, m_ell, x0, 16)
        assert launched == counted
        for g, w, p in zip(got[:3], want[:3], pieces[:3]):
            assert np.array_equal(g, w) and np.array_equal(g, p)
        assert got[3:] == want[3:] == pieces[3:]
    assert ds.GRAPH_COUNTS['replays'] > replays


@pytest.mark.gpu
@pytest.mark.parametrize('pair, m', [(('f32', 'f32'), 16),
                                     (('f32', 'f64'), 8)], ids=['f32', 'f64'])
def test_captured_apply_equals_the_eager_apply(cuda, girder, pair, m):
    lo, hi = spectral_bounds(girder)
    ch = Chebyshev(girder, hi * 1e-4, hi, degree=32,
                   device_matrix=_matrix(girder, pair[0], cuda))
    fn, ops = ch.device_rows_operands(m, girder.shape[0],
                                      dtype=DTYPES[pair[1]])
    x = _iterates(girder.shape[0], m, DTYPES[pair[1]], cuda, 9)[0]
    want = fn(ops, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(ops, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(ops, x)
    for _ in range(2):
        out.fill_(float('nan'))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
