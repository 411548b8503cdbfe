"""Complex operands and complex values on the port's device sparse layouts,
on the CPU, against the JAX package.

The plain versions of the DIA, ELL and BSR applies (what a CPU tensor
takes) against the JAX package's XLA applies ``_dia_matmat_rows``,
``_ell_matmat`` and ``_bsr_matmat`` on the same complex inputs: 1e-13 of
the largest |entry| in c128 (the packages add in different orders), 1e-5 in
c64; and against SciPy the same.  A real block on complex values is held
to SciPy alone for ELL and BSR: there the JAX package's applies return the
block's real type, without the imaginary part (BSR), or raise (ELL).
The route a complex apply takes on the card (``ops/complex_rows.py``:
real and imaginary rows stacked into one real block, complex values as two
real applies) run here through the plain versions in its place, against the
plain version on the complex tensors: 1e-14 of the largest |entry| in c128
(two halves summed once more), 1e-6 in c64.  The mesh apply of a complex
block against the unsharded one: exact, or within 1e-15 of the largest
|entry|.

``partial_hevp`` on the complex Hermitian chain of
``tests/test_sparse.py:175`` with a complex Hermitian ``B = I + 0.25 H``
(H the chain's hopping part; B is diagonally dominant, so positive
definite): generalized shift-invert with B's device matrix on the CPU
(``device='cpu'``) against the JAX package (``arch='tpu'``), the same seed:
eigenvalues within 1e-10 relative, iteration counts within PR 9's
``SPREAD`` (the JAX package's own backends differ here); and against the
host algebra (``arch='cpu'``) and dense eigenvalues of the pencil, 1e-8.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as scs
import torch

from raleigh_tpu.core.solver import Options as JaxOptions
from raleigh_tpu.interfaces.partial_hevp import partial_hevp as jax_hevp
from raleigh_tpu.ops.spmm import _bsr_matmat, _dia_matmat_rows, _ell_matmat
from raleigh_tpu_torch import Options, partial_hevp
from raleigh_tpu_torch.examples.fe_model import fe_pencil
from raleigh_tpu_torch.examples.laplace import lap2d, lap3d
from raleigh_tpu_torch.ops import spmm_pallas as sp
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.ops.complex_rows import complex_rows
from raleigh_tpu_torch.ops.spmm import (BsrMatrix, DiaMatrix, EllMatrix,
                                        device_sparse)
from raleigh_tpu_torch.parallel.mesh import (ShardedRows, blockvec_sharding,
                                             make_mesh)
from raleigh_tpu_torch.core.device_solver import shard_operator

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores.
torch.set_num_threads(1)

C128, C64 = np.complex128, np.complex64
# (operand dtype, values dtype): a complex block on real values, real
# values' complex twin, and complex values under a real block
CASES = [(C128, np.float64), (C128, C128), (np.float64, C128),
         (C64, np.float32), (C64, C64)]


def _tol(dt):
    return 1e-13 if np.dtype(dt) in (np.complex128, np.float64) else 1e-5


def _complexify(a, dt, seed):
    """A Hermitian matrix of a's pattern: a's values plus i times an
    antisymmetric part (real dtypes keep a as it is)."""
    a = scs.csr_matrix(a, dtype=np.float64)
    if np.dtype(dt).kind != 'c':
        return a.astype(dt)
    rng = np.random.RandomState(seed)
    up = scs.triu(a, k=1).tocoo()
    im = scs.csr_matrix((rng.standard_normal(up.nnz), (up.row, up.col)),
                        shape=a.shape)
    return (a + 1j * (im - im.T)).astype(dt)


def _block(m, n, dt, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((m, n))
    if np.dtype(dt).kind == 'c':
        x = x + 1j * rng.standard_normal((m, n))
    return x.astype(dt)


def _near(got, want, dt):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.iscomplexobj(got)
    assert np.abs(got - want).max() <= _tol(dt) * np.abs(want).max()


@pytest.mark.parametrize('xdt,vdt', CASES)
def test_dia_plain_matches_jax(xdt, vdt):
    a = _complexify(lap3d(6, 7, 5, 1.0, 1.3, 0.7), vdt, 1)
    dm = DiaMatrix(a, dtype=vdt, device='cpu', exact=True)
    assert dm.val.is_complex() == (np.dtype(vdt).kind == 'c')
    x = _block(5, a.shape[0], xdt, 2)
    got = sw.dia_matmat_rows(dm.val, torch.from_numpy(x), dm.offsets_t)
    want = _dia_matmat_rows(jnp.asarray(dm.val.numpy()), jnp.asarray(x),
                            dm.offsets)
    _near(got.numpy(), want, xdt)
    _near(got.numpy(), (a @ x.T).T, xdt)


@pytest.mark.parametrize('xdt,vdt', CASES)
def test_ell_plain_matches_jax(xdt, vdt):
    a = _complexify(lap2d(9, 11, 1.0, 1.0), vdt, 3)
    em = EllMatrix(a, dtype=vdt, device='cpu', exact=True)
    x = _block(4, a.shape[0], xdt, 4)
    got = em.matmat_rows(torch.from_numpy(x))
    if np.dtype(xdt).kind == 'c':
        want = _ell_matmat(jnp.asarray(em.idx.numpy()),
                           jnp.asarray(em.val.numpy()), jnp.asarray(x.T)).T
        _near(got.numpy(), want, xdt)
    _near(got.numpy(), (a @ x.T).T, xdt)


@pytest.mark.parametrize('xdt,vdt', CASES)
def test_bsr_plain_matches_jax(xdt, vdt):
    a = _complexify(fe_pencil(9, 3, 0.1, seed=2, which='k'), vdt, 5)
    bm = BsrMatrix(a, dtype=vdt, bs=16, device='cpu', exact=True)
    assert bm.blocks.is_complex() == (np.dtype(vdt).kind == 'c')
    n = a.shape[0]
    x = _block(6, n, xdt, 6)
    got = sp.bsr_matmat_rows(bm.blocks, bm.block_indptr_t, bm.block_cols,
                             torch.from_numpy(x), n)
    bs, nb = bm.bs, bm.nb
    xt = np.zeros((nb * bs, x.shape[0]), dtype=x.dtype)
    xt[:n] = x.T
    y = _bsr_matmat(jnp.asarray(bm.blocks.numpy()),
                    jnp.asarray(bm.block_cols.numpy()),
                    jnp.asarray(bm.block_rows.numpy()),
                    jnp.asarray(xt.reshape(nb, bs, -1)), nb)
    want = np.asarray(y).reshape(nb * bs, -1)[:n].T
    if np.dtype(xdt).kind == 'c':
        _near(got.numpy(), want, xdt)
    _near(got.numpy(), (a @ x.T).T, xdt)


@pytest.mark.parametrize('layout', ['dia', 'bsr'])
@pytest.mark.parametrize('xdt,vdt', CASES)
def test_card_route_through_plain_versions(layout, xdt, vdt):
    """The card's complex route (stacked rows, two launches for complex
    values) with the plain version standing in for the kernel equals the
    plain version on the complex tensors."""
    a = _complexify(lap3d(5, 6, 7, 1.0, 1.0, 1.0), vdt, 7)
    n = a.shape[0]
    x = torch.from_numpy(_block(7, n, xdt, 8))
    if layout == 'dia':
        dm = DiaMatrix(a, dtype=vdt, device='cpu', exact=True)

        def real(v, s):
            assert not (v.is_complex() or s.is_complex())
            return sw.dia_matmat_rows_plain(v, s, dm.offsets_t)
        vals, whole = dm.val, sw.dia_matmat_rows_plain(dm.val, x,
                                                       dm.offsets_t)
    else:
        bm = BsrMatrix(a, dtype=vdt, bs=8, device='cpu', exact=True)

        def real(v, s):
            assert not (v.is_complex() or s.is_complex())
            return sp.bsr_matmat_rows_plain(v, bm.block_indptr_t,
                                            bm.block_cols, s, n)
        vals = bm.blocks
        whole = sp.bsr_matmat_rows_plain(vals, bm.block_indptr_t,
                                         bm.block_cols, x, n)
    got = complex_rows(real, vals, x)
    assert got.dtype == whole.dtype and whole.is_complex()
    tol = 1e-14 if got.dtype == torch.complex128 else 1e-6
    assert (got - whole).abs().max() <= tol * whole.abs().max()


@pytest.mark.parametrize('xdt,vdt', CASES[:3])
def test_sharded_complex_apply_equals_unsharded(xdt, vdt):
    """A complex block on a DIA matrix split over 8 shards of the CPU (the
    mesh apply's plain version over its piece table) and on ELL split by
    rows: equal to the unsharded apply."""
    mesh = make_mesh(8, ['cpu'] * 8)
    for a in (_complexify(lap3d(5, 6, 7, 1.0, 1.0, 1.0), vdt, 9),
              _complexify(scs.random(300, 300, density=0.03,
                                     random_state=4) + scs.eye(300), vdt,
                          10)):
        a = a + a.conj().T
        whole = device_sparse(a, dtype=vdt, device='cpu', exact=True)
        split = shard_operator(device_sparse(a, dtype=vdt, device='cpu',
                                             exact=True), mesh)
        x = torch.from_numpy(_block(5, a.shape[0], xdt, 11))
        y = split.matmat_rows(ShardedRows.split(x, blockvec_sharding(mesh)))
        want = whole.matmat_rows(x)
        assert y.dtype == want.dtype and want.is_complex()
        assert torch.equal(y.gather(), want) or (
            (y.gather() - want).abs().max() <= 1e-15 * want.abs().max())


@pytest.fixture
def f64_default():
    """c128 device values, as the JAX package keeps them under x64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def test_complex_values_carry_over_from_arrays(f64_default):
    """``from_arrays`` takes the JAX package's complex arrays."""
    from raleigh_tpu.ops import spmm as jspmm
    a = _complexify(fe_pencil(9, 3, 0.1, seed=2, which='k'), C128, 12)
    x = _block(3, a.shape[0], C128, 13)
    want = (a @ x.T).T
    jd = jspmm.DiaMatrix(_complexify(lap2d(8, 8, 1.0, 1.0), C128, 14),
                         dtype=C128)
    d = DiaMatrix.from_arrays(jd.offsets, np.asarray(jd.val), device='cpu',
                              exact=True)
    assert d.val.dtype == torch.complex128
    je = jspmm.EllMatrix(a, dtype=C128)
    e = EllMatrix.from_arrays(np.asarray(je.idx), np.asarray(je.val),
                              device='cpu')
    _near(e.matmat_rows(torch.from_numpy(x)).numpy(), want, C128)
    jb = jspmm.BsrMatrix(a, dtype=C128, bs=16)
    b = BsrMatrix.from_arrays(np.asarray(jb.blocks),
                              np.asarray(jb.block_cols), jb.block_indptr,
                              a.shape[0], device='cpu')
    assert b.blocks.dtype == torch.complex128
    _near(b.matmat_rows(torch.from_numpy(x)).numpy(), want, C128)


def _chain(n):
    """The complex Hermitian chain of tests/test_sparse.py:175 and B =
    I + 0.25 H, H its hopping part."""
    d = 1j * np.ones(n - 1)
    hop = scs.csr_matrix(scs.diags(d, 1) - scs.diags(d, -1))
    a = scs.csr_matrix(hop + scs.diags(np.linspace(0, 1, n)))
    b = scs.csr_matrix(scs.eye(n) + 0.25 * hop)
    return a, b


# The JAX package's own two backends take 11 (dense_jax) and 12
# (dense_numpy) iterations on this field from one seed: rounding decides
# the path, so the port is held within PR 9's spread of the JAX package's
# count (tests/test_torch_solver.py).
SPREAD = 20


def _iterations(text):
    return [int(v) for v in re.findall(r'iterations: (\d+)', text)]


def test_complex_generalized_shift_invert_matches_jax(capsys):
    n, sigma = 128, 0.3
    a, b = _chain(n)
    w = sla.eigh(a.toarray(), b.toarray(), eigvals_only=True)
    runs = []
    for fn, opt_cls, kw in ((jax_hevp, JaxOptions, {'arch': 'tpu'}),
                            (partial_hevp, Options, {'device': 'cpu'}),
                            (partial_hevp, Options, {'arch': 'cpu'})):
        capsys.readouterr()
        np.random.seed(3)
        opt = opt_cls()
        opt.orchestration = 'device'
        lmd, x, status = fn(a, B=b, sigma=sigma, which=4, tol=1e-8, verb=0,
                            opt=opt, **kw)
        runs.append((lmd, x, status, _iterations(capsys.readouterr().out)))
    (jl, jx, js, jit), (tl, tx, ts, tit), (hl, hx, hs, _) = runs
    assert ts == js == 0 and len(tit) == len(jit) == 1, (ts, js, tit, jit)
    assert abs(tit[0] - jit[0]) <= SPREAD, (tit, jit)
    assert tx.dtype == np.complex128 and tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= 1e-10 * np.abs(jl).max()
    assert np.abs(tl - hl[:len(tl)]).max() <= 1e-8 * np.abs(hl).max()
    near = np.sort(w[np.argsort(np.abs(w - sigma))[:len(tl)]])
    assert np.allclose(np.sort(tl), near, rtol=1e-8, atol=1e-10)
    r = a @ tx[:, :4] - (b @ tx[:, :4]) * tl[None, :4]
    assert np.linalg.norm(r) < 1e-6
