"""The PyTorch port imports neither jax nor anything of the JAX package:
import it and run its slices (lap3d 10^3 through DIA, a small girder pencil
through ELL and through hand-built BSR operators) in a fresh interpreter,
then look at sys.modules.  The port keeps its own copies of the host code
both packages need (``Options``, ``spectral_bounds``, ``examples.laplace``,
``examples.fe_model``), so no module whose top-level name is
``raleigh_tpu`` may be loaded.
"""

import json
import os
import subprocess
import sys

REFERENCE_MODULES = []

SCRIPT = r"""
import sys
import numpy as np
import raleigh_tpu_torch as rt
from raleigh_tpu_torch.examples.laplace import lap3d, lap3d_eigenvalues
a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
lo, hi = rt.spectral_bounds(a)
T = rt.Chebyshev(a, lo, hi, degree=10, device='cpu')
lmd, x, status = rt.partial_hevp(a, T=T, which=4, tol=1e-5, verb=-1,
                                 arch='gpu', device='cpu')
exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))[:4]
assert status == 0, status
assert np.abs(lmd - exact).max() / exact[-1] < 1e-4, lmd
assert rt.Options().max_iter == -1

# the finite-element path: ELL through partial_hevp, BSR through lobpcg
K, M = rt.fe_model.fe_pencil(9, 3, 0.1, seed=2)
lo, hi = rt.spectral_bounds(K)
T = rt.Chebyshev(K, hi * 1e-4, hi, degree=32, device='cpu')
assert type(T.device_matrix()).__name__ == 'EllMatrix'
ell, x, status = rt.partial_hevp(K, B=M, T=T, which=6, tol=1e-4, verb=-1,
                                 arch='gpu', device='cpu')
assert status == 0, status
Kn, Mn = rt.fe_model.fe_pencil(9, 3, 0.1, seed=2, relabel=False)
bK = rt.BsrMatrix(Kn, bs=128, device='cpu')
bM = rt.BsrMatrix(Mn, bs=128, device='cpu')
T = rt.Chebyshev(Kn, hi * 1e-4, hi, degree=32, device_matrix=bK)
n = Kn.shape[0]
bsr, x, resid, niter, status = rt.lobpcg(
    bK, 6, opB=bM, precond=T.device_rows_operands(16, n), tol=1e-4)
assert status == 0, status
# one mesh in two orderings: the same six eigenvalues
assert np.abs(bsr / np.sort(ell)[:6] - 1).max() < 1e-3, (ell, bsr)
import raleigh_tpu_torch.ops.stream
import json
print(json.dumps({'jax': sorted(
    m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')),
    'reference': sorted(
    m for m in sys.modules
    if m.split('.')[0] == 'raleigh_tpu')}))
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
    # one thread: the suite's worker processes already fill the cores
    env['OMP_NUM_THREADS'] = '1'
    out = subprocess.run([sys.executable, '-c', SCRIPT], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded['jax'] == [], out.stdout
    assert loaded['reference'] == REFERENCE_MODULES
