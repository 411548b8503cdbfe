"""The PyTorch port's device LOBPCG against the JAX package's, on the CPU,
from the same start block ``x0`` (made with NumPy: the packages' random
generators differ).

In f64 both run the same algorithm up to summation order, so eigenvalues
agree to 1e-10 relative and the iteration counts (whole chunks of 16) are
equal.
"""

import numpy as np
import pytest
import scipy.sparse as scs
import torch

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.algebra.sparse import spectral_bounds
from raleigh_tpu.core.device_solver import lobpcg as jax_lobpcg
from raleigh_tpu.examples.laplace import lap2d, lap3d, lap3d_eigenvalues
from raleigh_tpu.ops.spmm import device_sparse as jax_device_sparse
from raleigh_tpu_torch.algebra.sparse import Chebyshev
from raleigh_tpu_torch.core.device_solver import default_block, lobpcg
from raleigh_tpu_torch.ops.spmm import device_sparse

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope='module')
def lap():
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))
    x0 = np.random.RandomState(0).standard_normal((a.shape[0], 8))
    return a, exact, x0


@pytest.fixture(scope='module')
def pencil():
    a = lap2d(20, 20, 1.0, 1.0)
    n = a.shape[0]
    b = scs.diags(1.0 + np.random.RandomState(2).rand(n), format='csr')
    x0 = np.random.RandomState(3).standard_normal((n, 8))
    return a, b, x0


def _rel(got, want):
    return np.abs(np.sort(got) - np.sort(want)).max() / np.abs(want).max()


@pytest.mark.parametrize('case', ['plain', 'chebyshev', 'largest'])
def test_lobpcg_matches_jax(lap, f64_default, case):
    a, exact, x0 = lap
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    k, kw = 6, dict(tol=1e-8, maxit=300, x0=x0, dtype=np.float64)
    pre = jpre = None
    if case == 'chebyshev':
        pre = Chebyshev(a, lo, hi, degree=10, device='cpu') \
            .device_rows_operands(8, n, dtype=torch.float64)
        jpre = JaxChebyshev(a, lo, hi, degree=10, arch='tpu') \
            .device_rows_operands(8, n, dtype=np.float64)
    if case == 'largest':
        k, kw = 3, dict(kw, largest=True, tol=1e-6)
    dm = device_sparse(a, dtype=np.float64, device='cpu')
    lam, x, r, it, st = lobpcg(dm, k, precond=pre, **kw)
    jlam, _, _, jit, jst = jax_lobpcg(
        jax_device_sparse(a, dtype=np.float64), k, precond=jpre, **kw)
    assert st == jst == 0
    assert it == jit
    assert _rel(lam, jlam) < 1e-10
    want = exact[-k:] if case == 'largest' else exact[:k]
    assert _rel(lam, want) < 1e-10
    assert np.abs(x.T @ x - np.eye(k)).max() < 1e-8


def test_bf16_stream_iteration_parity(lap):
    """The accuracy guard of bf16 Chebyshev streaming, f32 outer
    iteration: a preconditioner is percent-level by design, so bf16
    iterates must not change the iteration count, counted in host-check
    chunks of 16 (tests/test_device_solver.py:681-712 holds the JAX
    package so).

    At 1e-4 the counts are equal.  At 1e-5 the port's bf16 run may take
    one more chunk than its f32 run: eager PyTorch rounds the result of
    every bf16 operation (XLA may keep f32 between the operations it
    fuses), and at equal iterations its residual is about 1.5 times the
    f32 run's, which here falls across a chunk boundary.  It takes
    exactly as many chunks as the JAX package's bf16 run from the same
    start block."""
    a, exact, x0 = lap
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, hi * 1e-4, hi, degree=10, device='cpu')
    jch = JaxChebyshev(a, hi * 1e-4, hi, degree=10, arch='tpu')
    dm = device_sparse(a, device='cpu')
    jdm = jax_device_sparse(a)
    for tol, slack in ((1e-4, 0), (1e-5, 16)):
        lam, its = {}, {}
        for flag in (False, True):
            pre = ch.device_rows_operands(8, n, stream_bf16=flag)
            lam[flag], _, _, its[flag], st = lobpcg(
                dm, 6, precond=pre, block_size=8, tol=tol, maxit=300,
                x0=x0)
            assert st == 0
        assert abs(its[True] - its[False]) <= slack, (tol, its)
        assert np.abs(lam[True] - lam[False]).max() < 1e-3 * hi
        jpre = jch.device_rows_operands(8, n, stream_bf16=True)
        _, _, _, jits, jst = jax_lobpcg(jdm, 6, precond=jpre, block_size=8,
                                        tol=tol, maxit=300, x0=x0)
        assert jst == 0 and its[True] == jits, (tol, its, jits)


@pytest.mark.parametrize('case', ['generalized', 'constraints'])
def test_lobpcg_pencil_matches_jax(pencil, f64_default, case):
    """Generalized A x = λ B x (B-inner-product iteration), and deflation
    against the first 6 B-orthonormal eigenvectors given as
    ``constraints`` (the next 4 pairs come out)."""
    a, b, x0 = pencil
    kw = dict(tol=1e-8, maxit=300, x0=x0, dtype=np.float64)
    jA = jax_device_sparse(a, dtype=np.float64)
    jB = jax_device_sparse(b, dtype=np.float64)
    tA = device_sparse(a, dtype=np.float64, device='cpu')
    tB = device_sparse(b, dtype=np.float64, device='cpu')
    k = 6
    if case == 'constraints':
        _, xc, _, _, st = jax_lobpcg(jA, 6, opB=jB, **kw)
        assert st == 0
        kw['constraints'] = xc
        k = 4
    lam, x, _, it, st = lobpcg(tA, k, opB=tB, **kw)
    jlam, _, _, jit, jst = jax_lobpcg(jA, k, opB=jB, **kw)
    assert st == jst == 0 and it == jit
    assert _rel(lam, jlam) < 1e-10
    assert np.abs(x.T @ (b @ x) - np.eye(k)).max() < 1e-8
    if case == 'constraints':
        assert np.abs(kw['constraints'].T @ (b @ x)).max() < 1e-8


def test_default_block_and_errors(lap):
    a, _, _ = lap
    assert default_block(4, 10 ** 6) == 16
    assert default_block(10, 125000) == 24
    dm = device_sparse(a, device='cpu')
    with pytest.raises(ValueError):
        lobpcg(dm, 6, block_size=4)
    with pytest.raises(TypeError, match='blockvec_sharding'):
        lobpcg(dm, 6, sharding=object())


def test_lobpcg_takes_a_bare_callable(lap, f64_default):
    """A column-layout callable on tensors, with ``n`` given, is the same
    operator as the DIA matrix it wraps."""
    a, exact, x0 = lap
    dm = device_sparse(a, dtype=np.float64, device='cpu')
    kw = dict(tol=1e-8, maxit=300, x0=x0, dtype=np.float64)
    lam, _, _, it, st = lobpcg(dm, 6, **kw)
    lam2, _, _, it2, st2 = lobpcg(dm.matmat_t, 6, n=a.shape[0],
                                  device='cpu', **kw)
    assert st == st2 == 0 and it == it2
    assert _rel(lam2, lam) < 1e-12


# ---- the step in pieces, and the rule that sends it to CUDA graphs ---------

def _step_before(matmat, matmat_b, precond, y, ay, by, generalized, m, sign,
                 eps_rel, sqrt_eps, device):
    """The LOBPCG step as one function, as the port ran it before it was
    split at its eigh calls: the reference the pieces are held to."""
    from raleigh_tpu_torch.core.device_solver import (
        _cat, _gram, _mixed, _normalize_drop_pair, _ortho_against_pair,
        _row_dots, _scaled, _whiten_pair)

    def eigh_small(h):
        wide = torch.complex128 if h.is_complex() else torch.float64
        w, v = torch.linalg.eigh(h.to(wide))
        return w.to(h.real.dtype), v.to(h.dtype)

    def step(x, ax, bx, p, ap, bp, anorm):
        q = _gram(by, x)
        x = x - _mixed(q.transpose(0, 1), y)
        ax = ax - _mixed(q.transpose(0, 1), ay)
        if generalized:
            bx = bx - _mixed(q.transpose(0, 1), by)
        else:
            bx = x
        lam = _row_dots(x, ax)
        anorm = torch.maximum(anorm, lam.abs().max())
        w = ax - _scaled(lam[:, None].to(x.dtype), bx)
        w = precond(w).to(w.dtype)
        w, _, dead_w = _normalize_drop_pair(w, w, sqrt_eps)
        w = _ortho_against_pair(w, y, by)
        w = _ortho_against_pair(w, x, bx)
        bw = matmat_b(w)
        w, bw, dead_w = _normalize_drop_pair(w, bw, sqrt_eps, dead_w)
        w, bw, dead_w = _whiten_pair(w, bw, eps_rel, sqrt_eps, dead_w)
        aw = matmat(w)
        p, _, dead_p = _normalize_drop_pair(p, p, sqrt_eps)
        p = _ortho_against_pair(p, y, by)
        p = _ortho_against_pair(p, x, bx)
        p = _ortho_against_pair(p, w, bw)
        bp = matmat_b(p)
        p, bp, dead_p = _normalize_drop_pair(p, bp, sqrt_eps, dead_p)
        p, bp, dead_p = _whiten_pair(p, bp, eps_rel, sqrt_eps, dead_p)
        ap = matmat(p)
        s = _cat((x, w, p))
        a_s = _cat((ax, aw, ap))
        h = _gram(s, a_s)
        h = 0.5 * (h + h.conj().transpose(0, 1)) * sign
        dead = torch.cat((torch.zeros(m, dtype=torch.bool, device=device),
                          dead_w, dead_p))
        big = (torch.diagonal(h).abs().max() + 1.0) * (4.0 * s.shape[0])
        h = h + torch.diag(torch.where(dead, big, 0.0).to(h.dtype))
        _, c = eigh_small(h)
        cm = c[:, :m]
        xn = _mixed(cm.transpose(0, 1), s)
        axn = _mixed(cm.transpose(0, 1), a_s)
        cwp = cm.clone()
        cwp[:m] = 0
        pn = _mixed(cwp.transpose(0, 1), s)
        apn = _mixed(cwp.transpose(0, 1), a_s)
        if generalized:
            b_s = _cat((bx, bw, bp))
            bxn = _mixed(cm.transpose(0, 1), b_s)
            bpn = _mixed(cwp.transpose(0, 1), b_s)
        else:
            bxn, bpn = xn, pn
        return xn, axn, bxn, pn, apn, bpn, anorm
    return step


def _step_case(pencil, case, dtype=torch.float64):
    """The arguments of a step on the small pencil (A alone unless
    'generalized'), a Chebyshev preconditioner, and a random state whose
    P is not 0: (step arguments, state)."""
    a, b, x0 = pencil
    n, m = a.shape[0], 8
    dev = torch.device('cpu')
    dm = device_sparse(a, dtype=np.float64, device='cpu')
    lo, hi = spectral_bounds(a)
    fn, ops = Chebyshev(a, lo, hi, degree=6, device='cpu') \
        .device_rows_operands(m, n, dtype=dtype)
    generalized = case == 'generalized'
    bm = device_sparse(b, dtype=np.float64, device='cpu')

    def matmat(v):
        return dm.matmat_rows(v).to(v.dtype)

    def matmat_b(v):
        return bm.matmat_rows(v).to(v.dtype) if generalized else v

    eps = torch.finfo(dtype).eps
    gen = torch.Generator().manual_seed(5)
    rows = torch.randn((2 * m + 4, n), generator=gen, dtype=dtype)
    if case == 'constraints':
        y = torch.linalg.qr(rows[2 * m:].T)[0].T.contiguous()
    else:
        y = torch.zeros((0, n), dtype=dtype)
    x = torch.linalg.qr(rows[:m].T)[0].T.contiguous()
    p = rows[m:2 * m] * 1e-2
    bx = matmat_b(x)
    state = (x, matmat(x), bx, p, matmat(p), matmat_b(p),
             torch.zeros((), dtype=dtype))
    args = (matmat, matmat_b, lambda w: fn(ops, w), y, matmat(y),
            matmat_b(y), generalized, m, -1.0 if case == 'largest' else 1.0,
            100 * eps, float(np.sqrt(eps)), dev)
    return args, state


@pytest.mark.parametrize('case', ['standard', 'generalized', 'constraints',
                                  'largest'])
def test_pieces_compose_to_the_step_before(pencil, case):
    """The step's four pieces, run eagerly with an eigh between each two,
    give the state the one-piece step gave, bit for bit; the state they
    leave in ``into`` is the same again."""
    from raleigh_tpu_torch.core import device_solver as ds
    args, state = _step_case(pencil, case)
    want = _step_before(*args)(*state)
    before = ds.GRAPH_COUNTS['eager_pieces']
    step = ds._Step(*args)
    got = step(state)
    assert ds.GRAPH_COUNTS['eager_pieces'] == before + 4
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert not torch.equal(got[3], torch.zeros_like(got[3]))
    # the last piece writing into a state of its own
    into = tuple(torch.empty_like(t) for t in state)
    pieces = step.pieces()
    carry, mat = pieces[0](*state)
    for piece in pieces[1:3]:
        carry, mat = piece(carry, *torch.linalg.eigh(mat))
    out = pieces[3](carry, *torch.linalg.eigh(mat), into=into)
    assert all(o is i for o, i in zip(out, into) if case == 'generalized')
    assert out[0] is into[0] and out[6] is into[6]
    for g, w in zip(out, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('case', ['cpu', 'sharded', 'constraints',
                                  'complex'])
def test_graph_rule_keeps_these_solves_eager(lap, case):
    """The rule (``_graphable``) sends a solve on the CPU, one on
    ``ShardedRows`` blocks, one with constraints and one on complex blocks
    to the eager path, where the same solve without that feature on a card
    would take graphs; the solve runs every piece eagerly, as
    ``GRAPH_COUNTS`` shows."""
    from raleigh_tpu_torch.core import device_solver as ds
    from raleigh_tpu_torch.parallel.mesh import blockvec_sharding, make_mesh
    a, exact, x0 = lap
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    dm = device_sparse(a, device='cpu')
    pre = Chebyshev(a, lo, hi, degree=6, device='cpu') \
        .device_rows_operands(8, n)
    rule = dict(op=dm, opB=None, precond=pre, device=torch.device('cuda'),
                sharding=None, constraints=None, dtype=torch.float32)
    assert ds._graphable(**rule)
    kw = dict(tol=1e-4, maxit=64, x0=x0)
    k = 4
    if case == 'cpu':
        rule['device'] = torch.device('cpu')
    elif case == 'sharded':
        rule['sharding'] = kw['sharding'] = blockvec_sharding(
            make_mesh(2, ['cpu', 'cpu']))
        pre = None
    elif case == 'constraints':
        rule['constraints'] = kw['constraints'] = \
            np.linalg.eigh(a.toarray())[1][:, :2]
    else:
        rule['dtype'] = kw['dtype'] = torch.complex128
        pre = None
    assert not ds._graphable(**rule)
    before = dict(ds.GRAPH_COUNTS)
    lam, x, _, it, st = lobpcg(dm, k, precond=pre, **kw)
    assert st == 0
    want = exact[2:2 + k] if case == 'constraints' else exact[:k]
    assert _rel(lam, want) < 1e-4
    assert ds.GRAPH_COUNTS == dict(before,
                                   eager_pieces=before['eager_pieces']
                                   + 4 * it)


def _stand_in_capture(pool, fn, *args, **kwargs):
    """A CPU stand-in for ``device_solver._capture``: it runs the piece,
    and its replay runs it again and copies what it returns into the
    tensors the first run returned, as a CUDA graph's replay rewrites the
    memory its capture left."""
    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            return [obj]
        return [t for o in obj for t in tensors(o)] \
            if isinstance(obj, tuple) else []

    out = fn(*args, **kwargs)

    class Graph:
        @staticmethod
        def replay():
            for old, new in zip(tensors(out), tensors(fn(*args, **kwargs))):
                if old is not new:
                    old.copy_(new)
    return Graph(), out


@pytest.mark.parametrize('case', ['standard', 'generalized'])
def test_graph_path_gives_the_eager_solve(pencil, f64_default, case,
                                          monkeypatch):
    """The graph path's data flow on the CPU, with the capture stood in
    for (``_stand_in_capture``): the first call runs one iteration eagerly
    and captures the four pieces at the second, a later call replays every
    piece from its first iteration, and both give the eager solve's
    eigenvalues, vectors and iterations bit for bit."""
    from raleigh_tpu_torch.core import device_solver as ds
    a, b, x0 = pencil
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    ch = Chebyshev(a, lo, hi, degree=6, device='cpu')
    dm = device_sparse(a, dtype=np.float64, device='cpu')
    dB = device_sparse(b, dtype=np.float64, device='cpu') \
        if case == 'generalized' else None
    kw = dict(opB=dB, tol=1e-9, maxit=200, x0=x0, dtype=np.float64, chunk=5)
    pre = ch.device_rows_operands(8, n, dtype=torch.float64)
    assert ch.device_rows_operands(8, n, dtype=torch.float64) is pre
    want = lobpcg(dm, 4, precond=pre, **kw)
    monkeypatch.setattr(ds, '_graphable', lambda *args: True)
    monkeypatch.setattr(ds, '_capture', _stand_in_capture)
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: None)
    monkeypatch.setattr(ds, '_GRAPHS', {})
    counts = []
    for _ in range(2):
        before = dict(ds.GRAPH_COUNTS)
        got = lobpcg(dm, 4, precond=pre, **kw)
        counts.append({k: v - before[k] for k, v in ds.GRAPH_COUNTS.items()})
        assert got[3] == want[3] and got[4] == want[4] == 0
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, w)
    it = want[3]
    assert counts == [dict(captures=4, replays=4 * (it - 1), eager_pieces=4),
                      dict(captures=0, replays=4 * it, eager_pieces=0)]
    assert len(ds._GRAPHS) == 1
