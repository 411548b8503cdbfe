"""The block-vector algebra on torch tensors (``algebra/dense_torch.py``,
``device='cpu'``) against the JAX package's ``dense_jax`` and the host
``dense_numpy``: every contract op in s/d/c/z on the same NumPy-seeded
inputs (f64 and c128 within 1e-10 of the largest entry, f32 and c64
within 1e-5), ``fill_random`` bit for bit, the compensated Gram's pins of
``tests/test_algebra.py`` (an f64 Gram of f32 data here), the module
helpers the core Solver batches its round trips through, the backend
selector ``algebra/dense.py``, and the port's copy of ``dense_numpy``.
"""

import os

import numpy as np
import pytest
import torch

from raleigh_tpu.algebra import dense_jax
from raleigh_tpu_torch.algebra import dense, dense_numpy, dense_torch

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
N = 203
NV = 13
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(m, n, dt):
    a = 2 * np.random.rand(m, n) - 1
    if np.dtype(dt).kind == 'c':
        a = a + 1j * (2 * np.random.rand(m, n) - 1)
    return a.astype(dt)


def _tol(dt):
    return 1e-5 if np.dtype(dt) in (np.float32, np.complex64) else 1e-10


BACKENDS = {'jax': (dense_jax, {}), 'numpy': (dense_numpy, {}),
            'torch': (dense_torch, {'device': 'cpu'})}


def _agree(scenario, dt):
    """Run ``scenario(backend, kw, dt)`` on the three backends from the
    same seed; every array it returns must agree within _tol(dt) of its
    largest entry."""
    out = {}
    for name, (be, kw) in BACKENDS.items():
        np.random.seed(11)
        out[name] = [np.asarray(r) for r in scenario(be, kw, dt)]
    for name in ('jax', 'numpy'):
        for got, want in zip(out['torch'], out[name]):
            assert got.shape == want.shape, (name, got.shape, want.shape)
            scale = max(np.abs(want).max(), 1.0) if want.size else 1.0
            err = np.abs(got - want).max() if want.size else 0.0
            assert err <= _tol(dt) * scale, (name, err)
    return out['torch']


def _dot_dots(be, kw, dt):
    u = be.Vectors(_rand(NV, N, dt), **kw)
    v = be.Vectors(_rand(NV, N, dt), **kw)
    return [u.dot(v), u.dots(v), u.dots(v, transp=True)]


def _multiply_add_scale(be, kw, dt):
    # np.array: dense_numpy's data() is a view of the storage
    a = _rand(NV, N, dt)
    q = _rand(NV, NV - 4, dt)
    q2 = _rand(NV, NV, dt)
    s = np.arange(NV).astype(np.float64)
    u = be.Vectors(a.copy(), **kw)
    w = be.Vectors(N, NV - 4, dt, **kw)
    u.multiply(q, w)
    out = [np.array(w.data())]
    v = be.Vectors(a.copy(), **kw)
    v.add(u, -0.5)
    out.append(np.array(v.data()))
    v = be.Vectors(a.copy(), **kw)
    v.add(u, -1.0, q2)
    out.append(np.array(v.data()))
    v = be.Vectors(a.copy(), **kw)
    v.add(u, s)
    out.append(np.array(v.data()))
    v.scale(np.maximum(s, 0))           # divide, skipping zeros
    out.append(np.array(v.data()))
    v.scale(s + 1, multiply=True)
    out.append(np.array(v.data()))
    return out


def _select_copy_append(be, kw, dt):
    a = _rand(NV, N, dt)
    u = be.Vectors(a.copy(), **kw)
    u.select(3, 2)
    assert u.nvec() == 3 and u.selected() == (2, 3)
    w = be.Vectors(N, 3, dt, **kw)
    u.copy(w)
    w2 = be.Vectors(N, NV, dt, **kw)
    w2.select(3, 1)
    u.copy(w2, ind=np.array([4, 0, 2]))
    v = be.Vectors(a[:2].copy(), **kw)
    v.append(be.Vectors(a[5:7].copy(), **kw))
    assert v.nvec() == 4
    return [u.data(), w.data(), w2.all_data()[1:4], v.all_data()]


def _fill_zero_clone(be, kw, dt):
    u = be.Vectors(N, NV, dt, **kw)
    u.fill_random()
    first = np.array(u.data())
    c = u.clone()
    u.select(4, 1)
    u.zero()
    zeroed = np.array(u.all_data())
    u.fill(np.ones((4, N), dtype=dt))
    o = be.Vectors(N, 5, dt, **kw)
    o.fill_orthogonal()
    return [first, zeroed, c.data(), u.all_data(), o.data()]


def _orthogonalize(be, kw, dt):
    q, _ = np.linalg.qr(_rand(N, NV, dt))
    u = be.Vectors(np.ascontiguousarray(q.T.conj()), **kw)
    v = be.Vectors(_rand(4, N, dt), **kw)
    coef = v.orthogonalize(u)
    return [v.data(), coef.data(), u.dot(v)]


def _svd(be, kw, dt):
    """Sign-free results of the SVD: singular values, V V^H and the
    reconstruction of the block."""
    m = 10
    a = _rand(m, N, dt)
    u0, _, vh0 = np.linalg.svd(a, full_matrices=False)
    a = ((u0 * np.logspace(0, -3, m)) @ vh0).astype(dt)
    v = be.Vectors(a.copy(), **kw)
    sigma, qu = v.svd()
    vh = v.data()
    return [sigma, vh @ vh.conj().T, (qu.conj() * sigma) @ vh]


def _matrix_apply(be, kw, dt):
    m = 17
    a = _rand(m, N, dt)
    A = be.Matrix(a.copy(), **kw)
    vx = be.Vectors(_rand(5, N, dt), **kw)
    vy = be.Vectors(m, 5, dt, **kw)
    A.apply(vx, vy)
    vz = be.Vectors(_rand(5, m, dt), **kw)
    vw = be.Vectors(N, 5, dt, **kw)
    A.apply(vz, vw, transp=True)
    return [vy.data(), vw.data(), A.dots()]


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('scenario', [
    _dot_dots, _multiply_add_scale, _select_copy_append, _fill_zero_clone,
    _orthogonalize, _svd, _matrix_apply],
    ids=lambda f: getattr(f, '__name__', str(f)).strip('_'))
def test_contract_op_matches_jax_and_numpy(scenario, dt):
    out = _agree(scenario, dt)
    for r in out:
        assert r.dtype.kind == np.dtype(dt).kind or r.dtype.kind == 'f'
    if scenario is _svd:
        assert np.allclose(out[1], np.eye(10),
                           atol=1e-4 if _tol(dt) > 1e-8 else 1e-9)


@pytest.mark.parametrize('dt', DTYPES)
def test_multiply_in_place_matches_jax(dt):
    """``multiply`` into its own block (dense_jax's aliased variant; the
    svd's rotations): the product is taken before the block is written."""
    out = []
    for be, kw in (BACKENDS['jax'], BACKENDS['torch']):
        np.random.seed(5)
        u = be.Vectors(_rand(NV, N, dt), **kw)
        q = _rand(NV, NV, dt)
        want = q.T @ u.data()
        u.multiply(q, u)
        assert np.abs(u.data() - want).max() <= _tol(dt) * np.abs(want).max()
        out.append(u.data())
    assert np.abs(out[1] - out[0]).max() <= _tol(dt) * np.abs(out[0]).max()


def test_kept_results_stay_on_the_device_and_keep_the_type():
    np.random.seed(3)
    u = dense_torch.Vectors(_rand(4, 64, np.float32), device='cpu')
    g = u.dot(u, keep=True)
    d = u.dots(u, keep=True)
    assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
    assert isinstance(d, torch.Tensor) and d.shape == (4,)
    v = dense_torch.Vectors(64, 4, np.float32, device='cpu')
    u.multiply(g, v)                    # a kept Gram as a coefficient matrix
    v.scale(dense_torch.rootabs(d))     # kept per-vector coefficients
    want = (g.numpy().T @ u.data()) / np.sqrt(np.abs(d.numpy()))[:, None]
    assert np.abs(v.data() - want).max() < 1e-5 * np.abs(want).max()


def test_fill_random_bit_identical():
    """The host generator draws for all three backends."""
    blocks = []
    for be, kw in BACKENDS.values():
        np.random.seed(7)
        v = be.Vectors(64, 5, np.float64, **kw)
        v.fill_random()
        blocks.append(v.data())
    assert np.array_equal(blocks[0], blocks[2])
    assert np.array_equal(blocks[1], blocks[2])


def test_compensated_gram_accuracy():
    """The pins of tests/test_algebra.py: f32 storage with compensated
    Gram reductions, here an f64 Gram of the f32 data, recovers f64 dot
    products (1e-10 relative against an f64 oracle at n = 200k, where the
    plain f32 contraction carries ~1e-6), and complex pairing, clones,
    kept (plain) results and transposed dots behave as in dense_jax."""
    rng = np.random.RandomState(5)
    m, n = 6, 200000
    a64 = rng.standard_normal((m, n)) * np.exp(rng.standard_normal((m, n)))
    b64 = rng.standard_normal((m, n))
    a32, b32 = a64.astype(np.float32), b64.astype(np.float32)
    oracle = b32.astype(np.float64) @ a32.astype(np.float64).T
    kw = {'device': 'cpu'}

    va = dense_torch.Vectors(a32, compensated=True, **kw)
    vb = dense_torch.Vectors(b32, **kw)
    g = va.dot(vb)
    assert g.dtype == np.float64
    scale = np.abs(oracle).max()
    assert np.abs(g - oracle).max() / scale < 1e-12

    plain = dense_torch.Vectors(a32, **kw).dot(vb)
    assert np.abs(plain - oracle).max() / scale > 1e-9   # plain f32 floor

    c32 = (a64 + 1j * b64).astype(np.complex64)
    vc = dense_torch.Vectors(c32, compensated=True, **kw)
    d = vc.clone().dots(vc)
    dot_oracle = np.einsum('ij,ij->i', c32.conj().astype(np.complex128),
                           c32.astype(np.complex128))
    assert np.abs(d - dot_oracle).max() / np.abs(dot_oracle).max() < 1e-12

    kept = va.dot(vb, keep=True)
    assert kept.dtype == torch.float32

    small = 2048
    vs = dense_torch.Vectors(a32[:, :small], compensated=True, **kw)
    ws = dense_torch.Vectors(b32[:, :small], **kw)
    dt = vs.dots(ws, transp=True)
    assert dt.dtype == np.float64
    oracle_t = np.einsum('ij,ij->j', a32[:, :small].astype(np.float64),
                         b32[:, :small].astype(np.float64))
    assert np.abs(dt - oracle_t).max() / np.abs(oracle_t).max() < 1e-12
    plain_t = dense_torch.Vectors(a32[:, :small], **kw).dots(ws, transp=True)
    assert plain_t.dtype == np.float32


def test_compensated_solver_eigenvalues():
    """The solver-level pin of tests/test_algebra.py: the core Solver on
    f32 blocks with ``compensated=True`` reports 1e-10-class eigenvalues
    where the plain f32 path floors above 1e-8 — the final Rayleigh
    quotients, taken in f64, recover what the converged vectors carry."""
    import scipy.sparse as scs
    from raleigh_tpu_torch.algebra.sparse import SparseSymmetricMatrix
    from raleigh_tpu_torch.core.solver import (DefaultConvergenceCriteria,
                                               Options, Problem, Solver)

    n = 150_000
    rng = np.random.RandomState(2)
    d = (1.0 + 0.5 * np.round(rng.rand(n) * 1024) / 1024).astype(np.float32)
    top = np.array([4.0, 3.75, 3.5, 3.25], np.float32)
    d[:4] = top
    A = SparseSymmetricMatrix(scs.diags(d.astype(np.float64)).tocsr(),
                              device='cpu')

    def run(comp):
        v = dense_torch.Vectors(n, data_type=np.float32, compensated=comp,
                                device='cpu')
        opt = Options()
        opt.convergence_criteria = DefaultConvergenceCriteria()
        opt.convergence_criteria.set_error_tolerance(
            'residual eigenvector error', 1e-8)
        opt.verbosity = -1
        opt.max_iter = 500
        s = Solver(Problem(v, A))
        assert s.solve(v, opt, which=(0, 4)) == 0
        lmd = np.sort(s.eigenvalues)[::-1][:4]
        return np.abs(lmd - np.sort(top.astype(np.float64))[::-1]).max() / 4

    e_comp = run(True)
    e_plain = run(False)
    assert e_comp < 1e-10, e_comp
    assert e_plain > 1e-8, e_plain


def test_helpers_match_dense_numpy():
    """fetch (one transfer for several results), stage_coeff/combine,
    rootabs, diag_ratio and conjugation_beta on kept tensors agree with
    the host helpers on the same arrays."""
    rng = np.random.RandomState(1)
    a = rng.standard_normal((5, 5))
    b = rng.standard_normal((5, 5)) + 5 * np.eye(5)
    b[4, 4] = 0.0
    c = (rng.standard_normal(7) + 1j * rng.standard_normal(7))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    dense_torch.reset_counts()
    fa, fb, fnone, fc = dense_torch.fetch(ta, tb.float(), None, tc)
    assert dense_torch.COUNTS['to_host'] == 1
    assert np.array_equal(fa, a) and fc.dtype == np.complex128
    assert fb.dtype == np.float32 and np.array_equal(fb, b.astype(np.float32))
    assert np.array_equal(fc, c)
    staged = dense_torch.stage_coeff(a)
    assert np.allclose(dense_torch.combine(staged, tb).numpy(), a @ b,
                       rtol=0, atol=1e-13)
    assert np.allclose(dense_torch.combine(a, tb).numpy(), a @ b, atol=1e-13)
    assert np.array_equal(dense_torch.rootabs(tc).numpy(),
                          dense_numpy.rootabs(c))
    assert np.array_equal(dense_torch.diag_ratio(ta, tb).numpy(),
                          dense_numpy.diag_ratio(a, b))
    sy, sz = np.abs(rng.standard_normal(5)), np.abs(rng.standard_normal(4))
    zay, zby = rng.standard_normal((4, 5)), rng.standard_normal((4, 5))
    lmd_y, lmdz = np.arange(5.0), np.arange(4.0) + 0.5
    got = dense_torch.conjugation_beta(
        torch.from_numpy(zay), torch.from_numpy(zby), lmd_y, lmdz,
        torch.from_numpy(sy), torch.from_numpy(sz), np.float64)
    want = dense_numpy.conjugation_beta(zay, zby, lmd_y, lmdz, sy, sz,
                                        np.float64)
    assert np.abs(got.numpy() - want).max() < 1e-14 * np.abs(want).max()


def test_backend_selection_and_amatrix(monkeypatch):
    """'gpu'/'cuda' pick dense_torch, 'cpu' dense_numpy; 'gpu!' raises
    without a card, and dense_torch blocks never land on the CPU unasked."""
    assert dense.best_backend('gpu') == (dense_torch, 'torch')
    assert dense.best_backend('cuda') == (dense_torch, 'torch')
    assert dense.best_backend('cpu') == (dense_numpy, 'numpy')
    a = np.random.rand(6, 9)
    am = dense.AMatrix(a, arch='gpu', device='cpu')
    assert am.backend_name() == 'torch' and am.shape() == (6, 9)
    assert np.allclose(am.dots(), (a * a).sum(axis=1))
    assert np.allclose(am.as_vectors().data(), a)
    assert dense.AMatrix(a, arch='cpu').backend() is dense_numpy
    # a sharded block: one part per shard of a CPU mesh
    from raleigh_tpu_torch.parallel.mesh import blockvec_sharding, make_mesh
    sh = blockvec_sharding(make_mesh(2, ['cpu'] * 2))
    v = dense_torch.Vectors(8, 2, sharding=sh, device='cpu')
    assert [tuple(p.shape) for p in v.device_data().parts] == [(2, 4)] * 2
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA'):
        dense.best_backend('gpu!')
    with pytest.raises(RuntimeError, match='no CUDA'):
        dense_torch.Vectors(8, 2)


def test_dense_numpy_is_a_copy():
    """The port's host backend is the JAX package's, byte for byte."""
    def read(*parts):
        with open(os.path.join(ROOT, *parts)) as f:
            return f.read()
    assert read('raleigh_tpu_torch', 'algebra', 'dense_numpy.py') == \
        read('raleigh_tpu', 'algebra', 'dense_numpy.py')
