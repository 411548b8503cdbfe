"""The 48-mode modal analysis of the ship-section pencil (the benchmark's
cell ``shipsec1_modal48.lobpcg48``) at a small size on the CPU: the port's
device LOBPCG at which 48 and block 64 on the configuration's own maker
(``portbench/makers/fe_girder.py`` at nc = 8, n = 1,776), generalized,
with the cell's Chebyshev preconditioner and tolerance, f32 blocks, held
against a dense f64 ``eigh`` of the pencil and against the benchmark's
plain f64 reference (``portbench/references/lobpcg64.py``).

Tolerances, each with its readings (3 seeds, 16 iterations):

* eigenvalues within 1e-4 relative (read 2.2e-5 to 3.0e-5): below the
  smallest relative gap between neighbours among the 49 lowest (5.5e-4
  to 8.7e-4, checked), so a mode missed or out of order fails;
* the relative residual ||K x - lambda M x|| / (|lambda| ||M x||) within
  0.1 (read 1.1e-2 to 2.2e-2; a solve stopped after 8 iterations reads
  0.27 to 0.29): the stop is 1e-4 of the running largest Rayleigh
  quotient, not of each lambda;
* |X^T M X - I| within n u, u = 2^-24 (read 6e-6 to 1.1e-5): the bound of
  an f32 sum of n products (Higham, Accuracy and Stability, 3.1);
* the reference against the dense eigh within 1e-9 (read 7e-12 to
  9e-12): its stop is 1e-8 on each relative residual, and a Ritz value's
  error goes as the residual's square.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.linalg as sl
import torch

from portbench.makers import fe_girder
from portbench.references import lobpcg64
from raleigh_tpu_torch import Chebyshev, spectral_bounds
from raleigh_tpu_torch.core import device_solver as ds
from raleigh_tpu_torch.ops.spmm import EllMatrix

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

PORTBENCH = Path(__file__).resolve().parents[1] / 'portbench'
CONFIG = json.loads((PORTBENCH / 'configs' / 'shipsec1_modal48.json')
                    .read_text())
CELL = json.loads((PORTBENCH / 'workloads' / 'shipsec1_modal48.lobpcg48.json')
                  .read_text())
NC = 8
SEED = 2 ** 31 + 17
K = CELL['which']
EIG_TOL = 1e-4
RESID_TOL = 0.1
REF_TOL = 1e-9


@pytest.fixture(scope='module')
def modal():
    """The pencil, the port's answer and the ``eigh`` calls it made, the
    dense f64 eigenvalues (the 64 lowest) and the reference's."""
    p = fe_girder.make(dict(CONFIG['params'], nc=NC), SEED)
    k, mass = p['A'], p['B']
    n = k.shape[0]
    _, hi = spectral_bounds(k)
    cheb = CELL['chebyshev']
    ch = Chebyshev(k, hi * cheb['lo_ratio'], hi, degree=cheb['degree'],
                   device='cpu')
    ds.reset_counts()
    lam, x, _, its, status = ds.lobpcg(
        ch.device_matrix(), K, opB=EllMatrix(mass, device='cpu'),
        precond=ch.device_rows_operands(CELL['block'], n),
        block_size=CELL['block'], tol=CELL['tol'], device='cpu')
    eighs = dict(ds.EIGH_COUNTS)
    dense = sl.eigh(k.toarray(), mass.toarray(), subset_by_index=[0, 63],
                    eigvals_only=True)
    spec = CONFIG['reference']
    a = lobpcg64.csr_tensor(k, 'cpu')
    b = lobpcg64.csr_tensor(mass, 'cpu')
    h = lobpcg64.gershgorin_hi(k)
    ref, _, _ = lobpcg64.smallest(
        lambda v: a @ v, lambda v: b @ v, n, K, spec['block'],
        lobpcg64.chebyshev(lambda v: a @ v, h * spec['lo_ratio'], h,
                           spec['degree']),
        spec['tol'], spec['maxit'], spec['seed'], 'cpu')
    return SimpleNamespace(k=k, mass=mass, lam=lam, x=x, its=its,
                           status=status, eighs=eighs, dense=dense, ref=ref)


@pytest.mark.parametrize('against', ['dense', 'reference'])
def test_all_48_eigenvalues(modal, against):
    assert modal.status == 0 and len(modal.lam) == K
    want = modal.dense[:K] if against == 'dense' else modal.ref
    err = np.abs(np.asarray(modal.lam, dtype=np.float64) - want) / want
    assert err.max() <= EIG_TOL
    gaps = np.diff(modal.dense[:K + 1]) / modal.dense[1:K + 1]
    assert gaps.min() > 5 * EIG_TOL


def test_the_reference_is_the_dense_eigh(modal):
    err = np.abs(modal.ref - modal.dense[:K]) / modal.dense[:K]
    assert err.max() <= REF_TOL


def test_residuals_and_m_orthonormality(modal):
    x = modal.x.astype(np.float64)
    lam = np.asarray(modal.lam, dtype=np.float64)
    mx = modal.mass @ x
    rel = (np.linalg.norm(modal.k @ x - mx * lam, axis=0)
           / (np.abs(lam) * np.linalg.norm(mx, axis=0)))
    assert x.shape == (modal.k.shape[0], K)
    assert rel.max() <= RESID_TOL
    n = modal.k.shape[0]
    assert np.abs(x.T @ mx - np.eye(K)).max() <= n * 2.0 ** -24


def test_eigh_runs_at_the_block_and_three_times_it(modal):
    """Two whitenings an iteration at m = 64 in the blocks' f32, one
    Rayleigh-Ritz problem at 3m = 192 in f64, and the start block's
    whitening."""
    m = CELL['block']
    assert modal.eighs == {('f32', m): 2 * modal.its + 1,
                           ('f64', 3 * m): modal.its}


def test_the_default_block_is_the_cells_block():
    """``partial_hevp`` leaves the block to ``default_block``; at the
    cell's n it is the workload's ``block``, which its rooflines count
    with."""
    n = CONFIG['sizes']['n']
    assert ds.default_block(K, n) == CELL['block'] == CONFIG['block'] == 64
