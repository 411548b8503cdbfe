"""Basic core-solver usage demo (reference examples/core_solver.py).

Usage:
    python -m raleigh_tpu_torch.examples.core_solver [problem] [matrix] [n]
        [dtype] [left] [right] [vtol] [block_size] [verbosity] [precond]
        [arch]

The blocks live on the card (dense_torch) unless ``arch`` is 'cpu'
(dense_numpy) or ``device`` names another device.

Defaults reproduce the reference's doctest problem: 6 smallest eigenvalues
of diag(1..100) to eigenvector tolerance 1e-8 (reference
examples/core_solver.py:67-70 pins 58 iterations, eigenvalues [1..6]).

>>> test()
... # doctest: +NORMALIZE_WHITESPACE
6 converged eigenvalues are:
[1. 2. 3. 4. 5. 6.]
"""

import sys

import numpy as np

if __package__ in (None, ''):     # runnable as a plain script
    import os as _os
    import sys as _sys
    _sys.path.insert(0, _os.path.join(
        _os.path.dirname(_os.path.abspath(__file__)), '..', '..'))

from raleigh_tpu_torch.core.solver import (Options, Problem, Solver,
                                           DefaultConvergenceCriteria)

_DTYPES = {'s': np.float32, 'd': np.float64,
           'c': np.complex64, 'z': np.complex128}


def run(problem='std', matrix='diag', n=100, dt='d', left=6, right=0,
        vec_tol=1e-8, block_size=-1, verbosity=0, with_prec=False,
        arch='gpu', seed=1, device=None):
    if seed is not None:
        np.random.seed(seed)
    dtype = _DTYPES[dt]
    if str(arch).lower() == 'cpu':
        from raleigh_tpu_torch.algebra import dense_numpy as backend
        kw = {}
    else:
        from raleigh_tpu_torch.algebra import dense_torch as backend
        kw = {'device': device}

    opt = Options()
    opt.block_size = block_size
    opt.convergence_criteria = DefaultConvergenceCriteria()
    opt.convergence_criteria.set_error_tolerance('eigenvector error', vec_tol)
    opt.verbosity = verbosity

    v = backend.Vectors(n, data_type=dtype, **kw)
    if matrix.startswith('c'):
        if dt in 'sd':
            raise ValueError('central differences matrix requires complex'
                             ' data')
        d = 1j * np.ones((n - 1,), dtype=dtype)
        A = backend.Matrix(np.diag(d, 1) - np.diag(d, -1), **kw)
        a = None
    else:
        a = np.arange(1, n + 1).astype(dtype)
        A = backend.Matrix(np.diag(a), **kw)
    if problem[0] != 's':
        B = backend.Matrix(np.diag(2 * np.ones((n,), dtype=dtype)), **kw)
    else:
        B = None
    evp = Problem(v, A, B, 'pro' if problem[0] == 'p' else None)
    solver = Solver(evp)
    if with_prec:
        if problem[0] == 'p':
            raise ValueError('preconditioning does not work for matrix'
                             ' product')
        solver.set_preconditioner(backend.Matrix(np.diag(1 / a), **kw))
    solver.solve(v, opt, which=(left, right))
    return solver, v


def test():
    solver, v = run()
    print('%d converged eigenvalues are:' % v.nvec())
    out = np.array_str(np.sort(solver.eigenvalues))
    print(out[0] + out[2:] if out[1] == ' ' else out)


if __name__ == '__main__':
    args = sys.argv[1:]
    if args and args[0] in ('-h', '--help'):
        print(__doc__)
    elif args:
        problem, matrix = (args + ['std', 'diag'])[:2]
        n = int(args[2]) if len(args) > 2 else 100
        dt = args[3] if len(args) > 3 else 'd'
        left = int(args[4]) if len(args) > 4 else 6
        right = int(args[5]) if len(args) > 5 else 0
        solver, v = run(problem, matrix, n, dt, left, right,
                        verbosity=int(args[8]) if len(args) > 8 else 0,
                        arch=args[10] if len(args) > 10 else 'gpu')
        print('after %d iterations, %d converged eigenvalues:'
              % (solver.iteration, v.nvec()))
        print(np.sort(solver.eigenvalues))
    else:
        import doctest
        doctest.testmod(verbose=True)
