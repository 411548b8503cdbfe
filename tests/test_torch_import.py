"""The PyTorch port never imports jax: import it and run its slice (lap3d
10^3, 4 smallest) in a fresh interpreter, then look at sys.modules.

The port shares jax-free host code with the JAX package by import
(``Options``, ``spectral_bounds``, ``examples.laplace``).  The modules of
``raleigh_tpu`` that this loads are pinned here, so that a change of the
reference's imports shows up as a failure and not as a silent dependency.
"""

import json
import os
import subprocess
import sys

REFERENCE_MODULES = [
    'raleigh_tpu', 'raleigh_tpu.algebra', 'raleigh_tpu.algebra.dense',
    'raleigh_tpu.algebra.sparse', 'raleigh_tpu.core',
    'raleigh_tpu.core.dense_small', 'raleigh_tpu.core.solver',
    'raleigh_tpu.examples', 'raleigh_tpu.examples.laplace',
    'raleigh_tpu.utils', 'raleigh_tpu.utils.verbosity']

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
import json
print(json.dumps({'jax': 'jax' in sys.modules, 'reference': sorted(
    m for m in sys.modules
    if m.split('.')[0] == 'raleigh_tpu')}))
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
    out = subprocess.run([sys.executable, '-c', SCRIPT], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded['jax'] is False, out.stdout
    assert loaded['reference'] == REFERENCE_MODULES
