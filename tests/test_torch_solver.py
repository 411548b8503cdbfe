"""The port's core block Jacobi-CG ``Solver`` on ``dense_torch`` blocks
(``device='cpu'``) against the JAX package's ``Solver`` on ``dense_jax``,
on the reference's demo problems (diag(1..n) std/gen/pro, both ends,
largest magnitude, preconditioned, complex, warm restart, dense fallback,
the iteration-limit status): the same NumPy-seeded starting blocks, so the
two iterate alike.  f64: the same iteration count (within ``SPREAD`` on the
two problems where rounding decides the path in the JAX package too) and
eigenvalues within 1e-10 relative; f32 within 1e-5.  Also the doctest pin of
``examples/core_solver.py`` (58 iterations, BASELINE.md) on dense_torch,
and the port's copy of ``core/dense_small.py`` against the original.
"""

import os

import numpy as np
import pytest
import torch

from raleigh_tpu.algebra import dense_jax
from raleigh_tpu.core import solver as jsolver
from raleigh_tpu_torch.algebra import dense_torch
from raleigh_tpu_torch.core import solver as tsolver

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

N = 100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tol(dt):
    return 1e-10 if np.dtype(dt).itemsize in (8, 16) and \
        np.dtype(dt) != np.complex64 else 1e-5


def _backends(pkg):
    if pkg == 'jax':
        return jsolver, dense_jax, {}
    return tsolver, dense_torch, {'device': 'cpu'}


def _options(mod, vtol=1e-8, verb=-1):
    opt = mod.Options()
    opt.convergence_criteria = mod.DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('eigenvector error', vtol)
    opt.verbosity = verb
    return opt


def _diag_problem(pkg, dt, problem, n=N, precond=False):
    mod, be, kw = _backends(pkg)
    v = be.Vectors(n, data_type=dt, **kw)
    a = np.arange(1, n + 1).astype(dt)
    A = be.Matrix(np.diag(a), **kw)
    B = None if problem == 'std' else \
        be.Matrix(np.diag(2 * np.ones((n,), dtype=dt)), **kw)
    solver = mod.Solver(mod.Problem(v, A, B,
                                    'pro' if problem == 'pro' else None))
    if precond:
        solver.set_preconditioner(be.Matrix(np.diag(1.0 / a), **kw))
    return mod, v, solver


# Where rounding decides the path: on the generalized diag(1..100), B = 2I
# problem, the largest-magnitude one and the complex central-difference
# matrix (real starting blocks against a spectrum symmetric about 0) the
# JAX package's own two backends take different iteration counts from one
# seed (dense_numpy / dense_jax: 98 / 96, 84 / 80, and 79 / 84 with seed
# 1), and so does the port, within this many iterations of the JAX
# package.  Elsewhere the counts are equal.
SPREAD = 20


def _run_both(make, which, dt=np.float64, spread=0, **opts):
    """Run ``make(pkg)`` -> (options module, Vectors, Solver) on both
    packages from the same seed and compare: the same status, the wanted
    eigenvalues (the ``which`` ends) within the dtype's tolerance, and
    iteration counts equal, or within ``spread`` (``SPREAD``).  Returns
    the port's (status, iterations, sorted eigenvalues, nvec)."""
    out = []
    for pkg in ('jax', 'torch'):
        np.random.seed(4)
        mod, v, solver = make(pkg)
        opt = _options(mod, **{k: opts[k] for k in ('vtol',) if k in opts})
        for k, val in opts.items():
            if k != 'vtol':
                setattr(opt, k, val)
        status = solver.solve(v, opt, which=which)
        out.append((status, solver.iteration, np.sort(solver.eigenvalues),
                    v.nvec()))
    (sj, ij, lj, _), (st, it, lt, _) = out
    assert st == sj and abs(it - ij) <= spread, (out, dt)
    left, right = which if isinstance(which, tuple) else (0, which)
    for a, b in ((lt[:left], lj[:left]),
                 (lt[len(lt) - right:], lj[len(lj) - right:])):
        assert a.shape == b.shape
        if a.size:
            assert np.abs(a - b).max() <= _tol(dt) * np.abs(lj).max(), \
                (lt, lj)
    return out[1]


@pytest.mark.parametrize('problem', ['std', 'gen', 'pro'])
def test_smallest_six_matches_jax(problem):
    status, it, lmd, _ = _run_both(
        lambda pkg: _diag_problem(pkg, np.float64, problem), (6, 0),
        spread=SPREAD if problem == 'gen' else 0)
    assert status == 0 and it < 100
    want = {'std': np.arange(1, 7.0), 'gen': np.arange(1, 7) / 2.0,
            'pro': np.arange(1, 7) * 2.0}[problem]
    assert np.allclose(lmd[:6], want, atol=1e-6)


@pytest.mark.parametrize('dt', [np.float32, np.float64])
def test_both_ends_matches_jax(dt):
    status, _, lmd, _ = _run_both(
        lambda pkg: _diag_problem(pkg, dt, 'std'), (3, 3), dt=dt,
        vtol=1e-4 if dt == np.float32 else 1e-8)
    assert status == 0
    assert np.allclose(lmd[:3], [1, 2, 3], atol=1e-3)
    assert np.allclose(lmd[-3:], [98, 99, 100], atol=1e-3)


def test_largest_magnitude_matches_jax():
    status, _, lmd, _ = _run_both(
        lambda pkg: _diag_problem(pkg, np.float64, 'std'), 4, spread=SPREAD)
    assert status == 0
    assert np.allclose(lmd[-4:], [97, 98, 99, 100], atol=1e-6)


def test_preconditioned_matches_jax():
    status, _, lmd, _ = _run_both(
        lambda pkg: _diag_problem(pkg, np.float64, 'std', precond=True),
        (6, 0))
    assert status == 0
    assert np.allclose(lmd[:6], np.arange(1, 7), atol=1e-6)


@pytest.mark.parametrize('dt', [np.complex128])
def test_complex_central_difference_matches_jax(dt):
    def make(pkg):
        mod, be, kw = _backends(pkg)
        d = 1j * np.ones((N - 1,), dtype=dt)
        v = be.Vectors(N, data_type=dt, **kw)
        a = be.Matrix(np.diag(d, 1) - np.diag(d, -1), **kw)
        return mod, v, mod.Solver(mod.Problem(v, a))
    status, _, lmd, _ = _run_both(make, (3, 3), dt=dt, spread=SPREAD,
                                  vtol=1e-6)
    assert status == 0
    want = np.sort(2 * np.cos(np.arange(1, N + 1) * np.pi / (N + 1)))
    assert np.allclose(lmd[:3], want[:3], atol=1e-3)
    assert np.allclose(lmd[-3:], want[-3:], atol=1e-3)


def test_warm_restart_matches_jax():
    """Previously computed eigenvectors become constraints: the second
    solve computes the next three pairs."""
    def make(pkg):
        mod, be, kw = _backends(pkg)
        v = be.Vectors(N, data_type=np.float64, **kw)
        evp = mod.Problem(v, be.Matrix(np.diag(np.arange(1, N + 1.0)), **kw))
        assert mod.Solver(evp).solve(v, _options(mod), which=(3, 0)) == 0
        return mod, v, mod.Solver(evp)
    status, _, lmd, nv = _run_both(make, (3, 0))
    assert status == 0 and nv >= 6
    assert np.allclose(lmd[:3], [4, 5, 6], atol=1e-5)


def test_dense_fallback_matches_jax():
    """Block size >= n/2 takes the dense Rayleigh-Ritz path."""
    status, _, lmd, _ = _run_both(
        lambda pkg: _diag_problem(pkg, np.float64, 'std', n=10), (4, 0),
        block_size=8)
    assert status == 0
    assert np.allclose(lmd[:4], [1, 2, 3, 4], atol=1e-8)


def test_iteration_limit_status_matches_jax():
    status, it, _, _ = _run_both(
        lambda pkg: _diag_problem(pkg, np.float64, 'std'), (6, 0),
        vtol=1e-14, max_iter=2, detect_stagnation=False)
    assert status == 1 and it == 2


def test_core_solver_example_pin():
    """examples/core_solver.py's doctest problem on dense_torch: 58
    iterations and eigenvalues 1..6 (BASELINE.md), as on dense_numpy."""
    from raleigh_tpu_torch.examples import core_solver
    solver, v = core_solver.run(device='cpu')
    assert solver.iteration == 58 and v.nvec() == 6
    assert np.allclose(np.sort(solver.eigenvalues), np.arange(1, 7),
                       atol=1e-8)
    host, hv = core_solver.run(arch='cpu')
    assert host.iteration == 58 and hv.nvec() == 6
    assert np.abs(np.sort(host.eigenvalues)
                  - np.sort(solver.eigenvalues)).max() < 1e-10


def test_backend_helpers_find_dense_torch():
    """The Solver batches its round trips through dense_torch's own
    helpers, and falls back to dense_numpy's for a backend without them."""
    v = dense_torch.Vectors(8, 2, np.float64, device='cpu')
    assert tsolver._backend_helpers(v) is dense_torch

    class Plain:
        pass
    from raleigh_tpu_torch.algebra import dense_numpy
    assert tsolver._backend_helpers(Plain()) is dense_numpy


def test_copies_match_their_originals():
    """core/dense_small.py is the JAX package's, byte for byte; the
    Solver differs from its original only in the docstrings and comments
    that named the TPU: the same code, line for line."""
    def read(*parts):
        with open(os.path.join(ROOT, *parts)) as f:
            return f.read()
    assert read('raleigh_tpu_torch', 'core', 'dense_small.py') == \
        read('raleigh_tpu', 'core', 'dense_small.py')

    def code(text):
        import ast
        return ast.dump(_strip_docstrings(ast.parse(text)))
    assert code(read('raleigh_tpu_torch', 'core', 'solver.py')) == \
        code(read('raleigh_tpu', 'core', 'solver.py'))


def _strip_docstrings(tree):
    import ast
    for node in ast.walk(tree):
        body = getattr(node, 'body', None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], 'value', None),
                               ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return tree
