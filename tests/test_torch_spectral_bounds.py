"""``spectral_bounds`` on the 7-point Laplacian, whose Gershgorin lower
bound ``d - radius`` is 0 in exact arithmetic and rounds to either side of
it.  A bound at or below 0 gives the JAX package's numbers; a bound that
is positive by rounding alone takes the Lanczos branch, where the JAX
package keeps the residue (about 2e-16 of ``hi``, against lambda_1 ~ 28 at
the benchmark's 100 x 100 x 128 grid).  The inputs are the benchmark's own
(``portbench/makers/lap3d.py``) at its full size and at its test grid."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as scs
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.makers import lap3d
from raleigh_tpu.algebra.sparse import spectral_bounds as jax_spectral_bounds
from raleigh_tpu_torch import Chebyshev, DiaMatrix, partial_hevp
from raleigh_tpu_torch.algebra import sparse
from raleigh_tpu_torch.algebra.sparse import spectral_bounds

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

PORTBENCH = Path(__file__).resolve().parents[1] / 'portbench'
PARAMS = json.loads((PORTBENCH / 'configs' / 'lap3d_1p28m.json')
                    .read_text())['params']
CELL = json.loads((PORTBENCH / 'workloads' / 'lap3d_1p28m.lobpcg4.json')
                  .read_text())
# the grid of the benchmark's own tests of this configuration
TEST_GRID = [16, 17, 18]
EPS = np.finfo(np.float64).eps


def _problem(seed, grid=None):
    params = PARAMS if grid is None else dict(PARAMS, grid=grid)
    return lap3d.make(params, seed)


def _gershgorin(a):
    d = a.diagonal()
    radius = np.abs(a).sum(axis=1).A.ravel() - np.abs(d)
    return float((d - radius).min()), float((d + radius).max())


def _lambda1(p):
    return float(np.min(lap3d.lap3d_eigenvalues(*p['grid'], *p['sides'])))


def _counted(a):
    sparse.reset_bounds_counts()
    bounds = spectral_bounds(a)
    return bounds, dict(sparse.BOUNDS_COUNTS)


def _takes_lanczos(p):
    """The residue takes the Lanczos branch, and its ``lo`` is no
    rounding: far above the residue, of the order of lambda_1 (the
    estimate is 0.25 of the smallest Ritz value of 20 steps)."""
    a = p['A']
    g_lo, g_hi = _gershgorin(a)
    assert 0 < g_lo <= 2 * EPS * g_hi          # the inputs' premise
    (lo, hi), counts = _counted(a)
    assert counts == {'calls': 1, 'lanczos': 1, 'lanczos_steps': 20}
    assert hi == g_hi
    assert 1e-6 * hi < lo < 10 * _lambda1(p)
    # the JAX package keeps the residue
    assert jax_spectral_bounds(a) == (g_lo, g_hi)


@pytest.mark.parametrize('seed', [2147484212, 2147484216])
def test_a_rounding_residue_takes_lanczos_at_full_size(seed):
    _takes_lanczos(_problem(seed))


@pytest.mark.parametrize('seed', [2 ** 31, 2 ** 31 + 8, 2 ** 31 + 10])
def test_a_rounding_residue_takes_lanczos_at_the_test_grid(seed):
    _takes_lanczos(_problem(seed, TEST_GRID))


@pytest.mark.parametrize('seed, grid', [
    (1, None), (2147483749, None),
    (2 ** 31 + 1, TEST_GRID), (2 ** 31 + 4, TEST_GRID),
    (2 ** 31 + 6, TEST_GRID)])
def test_a_bound_at_or_below_zero_is_the_originals(seed, grid):
    """Gershgorin's 0.0 (seeds 1, 2**31 + 1) and -2.9e-11 / -4.5e-13
    (the others) take the Lanczos branch in both packages alike."""
    a = _problem(seed, grid)['A']
    assert _gershgorin(a)[0] <= 0
    bounds, counts = _counted(a)
    assert bounds == jax_spectral_bounds(a)
    assert counts['lanczos'] == 1


def test_a_clear_gershgorin_bound_counts_no_lanczos():
    a = _problem(2 ** 31, TEST_GRID)['A']
    a = a + 0.5 * _gershgorin(a)[1] * scs.identity(a.shape[0])
    bounds, counts = _counted(a)
    assert bounds == jax_spectral_bounds(a) == _gershgorin(a)
    assert counts == {'calls': 1, 'lanczos': 0, 'lanczos_steps': 0}


def test_the_bounds_are_one_chebyshev_span():
    a = _problem(2 ** 31, TEST_GRID)['A']
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spectral_bounds(a)
    names = [e.name for e in prof.events() if e.name.startswith('raleigh.')]
    assert names == ['raleigh.chebyshev.bounds']


def test_the_laplacian_solves_on_the_dia_path(capsys):
    """The cell's solve at the test grid on the CPU, maker seed 2**31
    (Gershgorin's residue 9.09e-13 against ``hi`` 3,622): the 4 smallest
    eigenvalues within the cell's ``eig_err``.  With the residue for
    ``lo`` the same solve took 496 iterations to its tolerance."""
    p = _problem(2 ** 31, TEST_GRID)
    a = p['A']
    t = Chebyshev(a, *spectral_bounds(a), degree=CELL['chebyshev']['degree'],
                  device='cpu')
    assert isinstance(t.device_matrix(), DiaMatrix)
    lmd, x, status = partial_hevp(a, T=t, which=CELL['which'],
                                  tol=CELL['tol'], engine=CELL['engine'],
                                  device='cpu', verb=0)
    out = capsys.readouterr().out
    assert status == 0 and x.shape == (a.shape[0], CELL['which'])
    exact = np.sort(lap3d.lap3d_eigenvalues(*p['grid'], *p['sides']))
    k = CELL['which']
    err = np.max(np.abs(np.sort(lmd)[:k] - exact[:k]) / exact[:k])
    assert err < CELL['limits']['eig_err']
    iterations = int(out.split('iterations: ')[-1].split(',')[0])
    assert iterations <= 64
