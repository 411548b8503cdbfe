"""The port's randomized subspace engines (``raleigh_tpu_torch.interfaces.
randomized``) on the CPU (``device='cpu'``) against the JAX package's.

Each private helper gets the same starting block as the JAX one
(``jax.random.normal`` drawn once and handed to both): sigma and
``trans @ comps`` within 1e-10 relative in f64 and 1e-4 in f32, column
signs free.  With the port's draws replaced by ``jax.random``'s, the
public engines match the JAX package's the same way, and the
tolerance-driven modes pick the same rank.  With the port's own draws the
public engines are held by quality, on the cases of
``tests/test_randomized.py`` at smaller sizes.  Also the port's copy of
``examples/generate_matrix.py`` against the original, and ``_bucket`` /
``_next_subspace_size`` on a table of inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from raleigh_tpu.examples import generate_matrix as jgen
from raleigh_tpu.interfaces import randomized as jr
from raleigh_tpu_torch.examples import generate_matrix as tgen
from raleigh_tpu_torch.interfaces import randomized as tr
from raleigh_tpu_torch.interfaces.pca import pca, pca_error

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread for NumPy and SciPy inside these tests, for the
    same reason (their small products gain nothing from more), restored
    after each test."""
    with threadpool_limits(1):
        yield

M, N, RANK = 300, 200, 100


def _tol(dt):
    return 1e-10 if np.dtype(dt) == np.float64 else 1e-4


def _data(dt=np.float64, m=M, n=N, rank=RANK, pca_mode=True, alpha=0.75):
    np.random.seed(1)
    return tgen.generate(m, n, rank, dtype=dt, pca=pca_mode,
                         alpha=alpha)[0]


# The helpers' comparisons take data with no constant leading component
# (pca=False) and a faster decay (sigma_k ~ k^-1.5).  In f32 the centered
# Gram A A^T - r e^T - e r^T + |mean|^2 cancels the mean's energy: with the
# generator's constant leading vector two summation orders (XLA's and
# cuBLAS's or MKL's) leave 2e-3 of G apart.  And a component's direction
# moves by about the rounding of G over its spectral gap: at the default
# k^-0.75 the f32 gap at the 20th component leaves ~2.5e-4 of trans @ comps
# apart.  These data keep both packages' factors determined to the f32
# tolerance; the public engines are held on the generator's PCA data.
SPLIT = 1.5


def _start(shape, dt, seed=1):
    """jax.random's standard normal block, as the JAX engines draw it."""
    jdt = jnp.float64 if np.dtype(dt) == np.float64 else jnp.float32
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                      dtype=jdt))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, dt, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= _tol(dt), (what, err)


def _same_factors(jf, tf, dt):
    """(mean, trans, comps) of both packages: the same mean and
    trans @ comps (column signs cancel there)."""
    (jm, jt, jc), (tm, tt, tc) = [[np.asarray(v) for v in f]
                                  for f in (jf, tf)]
    _close(tm.reshape(-1), jm.reshape(-1), dt, 'mean')
    assert tc.shape == jc.shape
    _close(tt @ tc, jt @ jc, dt, 'trans @ comps')


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's public engines draw jax.random's numbers: both packages
    then start every subspace alike."""
    def normal(shape, like, seed):
        dt = np.float64 if like.dtype == torch.float64 else np.float32
        return _t(_start(shape, dt, seed)).to(like.device)
    monkeypatch.setattr(tr, '_normal', normal)


@pytest.mark.parametrize('pca_mode', [False, True])
@pytest.mark.parametrize('dt', [np.float32, np.float64])
def test_generate_matrix_copy_is_equal(dt, pca_mode):
    out = []
    for mod in (jgen, tgen):
        np.random.seed(5)
        out.append(mod.generate(120, 80, 40, dtype=dt, pca=pca_mode))
    for a, b in zip(*out):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bucket_and_next_subspace_size_equal():
    for l, cap in ((1, 4000), (128, 4000), (129, 4000), (300, 310),
                   (5000, 4000), (255, 256), (0, 10)):
        assert tr._bucket(l, cap) == jr._bucket(l, cap)
    k = np.arange(0, 1025)
    power = np.concatenate(([1.0], k[1:] ** -0.5))
    steep = np.concatenate(([1.0], k[1:] ** -2.0))
    flat_tail = power.copy()
    flat_tail[112:] = flat_tail[112]
    cases = [(power, 0.05, 128, 4000, None), (np.full(129, 0.5), 0.05, 128,
                                                 4000, None),
             (steep, 0.5, 128, 4000, None), (power, 0.0, 128, 4000, None),
             (power, -1.0, 128, 4000, None),
             (flat_tail, 0.05, 128, 4000, 112), (power, 0.01, 256, 600, 200),
             (steep, 1e-3, 64, 1000, None), (power, 0.2, 2, 50, None)]
    for prof, tol, l, cap, trusted in cases:
        assert tr._next_subspace_size(prof, tol, l, cap, trusted) == \
            jr._next_subspace_size(prof, tol, l, cap, trusted)


@pytest.mark.parametrize('dt', [np.float32, np.float64])
def test_subspace_pca_gram_matches_jax(dt):
    a = _data(dt, pca_mode=False, alpha=SPLIT)
    npc, over, iters = 6, 16, 6
    key = jax.random.PRNGKey(3)
    q = _start((M, npc + over), dt, 3)
    jm, jt, jc, js = jr._subspace_pca_gram(jnp.asarray(a), key, npc, over,
                                          iters)
    tm, tt, tc, ts = tr._subspace_pca_gram(_t(a), _t(q), npc, iters)
    assert tt.dtype == tc.dtype == (torch.float64 if dt == np.float64
                                    else torch.float32)
    _close(ts, js, dt, 'sigma')
    _same_factors((jm, jt, jc), (tm, tt, tc), dt)


@pytest.mark.parametrize('dt', [np.float32, np.float64])
def test_gram_helpers_match_jax(dt):
    """_centered_gram, then _gram_subspace, _row_error_profile,
    _rank_for_tol in every norm and _finalize_from_gram, each given the
    JAX helper's own inputs."""
    a = _data(dt, pca_mode=False, alpha=SPLIT)
    jG, jmean = jr._centered_gram(jnp.asarray(a))
    tG, tmean = tr._centered_gram(_t(a))
    _close(tG, jG, dt, 'G')
    _close(tmean, jmean, dt, 'mean')
    G, mean = _t(jG), _t(jmean)
    l = 40
    jl, ju = jr._gram_subspace(jG, jax.random.PRNGKey(1), l, 5)
    tl, tu = tr._gram_subspace(G, _t(_start((M, l), dt)), 5)
    _close(tl, jl, dt, 'lmd')
    lmd, u = _t(jl), _t(ju)
    sig = jnp.sqrt(jnp.maximum(jl, 0.0))
    _close(tr._row_error_profile(torch.diagonal(G), u[:, :10], _t(sig[:10])),
           jr._row_error_profile(jnp.diagonal(jG), ju[:, :10], sig[:10]), dt,
           'profile')
    for norm, tol in (('f', 0.2), ('m', 0.3), ('s', 0.05)):
        jk, jp = jr._rank_for_tol(jG, jl, ju, tol, norm)
        tk, tp = tr._rank_for_tol(G, lmd, u, tol, norm)
        assert tk == jk, (norm, tk, jk)
        _close(tp, jp, dt, 'profile ' + norm)
    jt, jc, js = jr._finalize_from_gram(jnp.asarray(a), jmean, ju, jl, 12)
    tt, tc, ts = tr._finalize_from_gram(_t(a), mean, u, lmd, 12)
    _close(ts, js, dt, 'sigma')
    _same_factors((jmean, jt, jc), (mean, tt, tc), dt)


@pytest.mark.parametrize('dt', [np.float32, np.float64])
def test_update_helpers_match_jax(dt):
    """_update_gram and _finalize_update on one old factorization and new
    rows: the pooled Gram, mean and comps."""
    a = _data(dt, pca_mode=False, alpha=SPLIT)
    a0, a1 = a[:200], a[200:]
    mean0, trans0, comps0 = jr.subspace_pca(a0, 30)
    jG, jmean, jd = jr._update_gram(jnp.asarray(mean0.reshape(-1)),
                                    jnp.asarray(trans0), jnp.asarray(comps0),
                                    jnp.asarray(a1))
    tG, tmean, td = tr._update_gram(_t(mean0.reshape(-1)), _t(trans0),
                                    _t(comps0), _t(a1))
    _close(tG, jG, dt, 'G')
    _close(tmean, jmean, dt, 'mean')
    _close(td, jd, dt, 'd')
    lmd, u = jr._gram_subspace(jG, jax.random.PRNGKey(2), 40, 5)
    jt, jc, js = jr._finalize_update(jnp.asarray(trans0), jnp.asarray(comps0),
                                     jnp.asarray(a1), jmean, jd, u, lmd, 15)
    tt, tc, ts = tr._finalize_update(_t(trans0), _t(comps0), _t(a1), tmean,
                                     td, _t(np.asarray(u)),
                                     _t(np.asarray(lmd)), 15)
    _close(ts, js, dt, 'sigma')
    _same_factors((jmean, jt, jc), (tmean, tt, tc), dt)


@pytest.mark.parametrize('dt', [np.float32, np.float64])
def test_rand_svd_matches_jax(dt):
    a = _data(dt, pca_mode=False, alpha=SPLIT)
    k, over, iters = 15, 10, 3
    key = jax.random.PRNGKey(4)
    ju, js, jvt = jr._rand_svd(jnp.asarray(a), key, k, over, iters)
    tu, ts, tvt = tr._rand_svd(_t(a), _t(np.array(jax.random.normal(
        key, (N, k + over), dtype=jnp.asarray(a).dtype))), k, iters)
    _close(ts, js, dt, 'sigma')
    _close((tu * ts) @ tvt, (ju * js) @ jvt, dt, 'u s vt')


def test_public_engines_match_jax_at_jax_start(jax_draws):
    """subspace_pca, subspace_pca_tol (in each norm: the same rank),
    subspace_pca_update (fixed npc and tolerance-driven),
    subspace_pca_stream and randomized_svd, given jax.random's starts."""
    dt = np.float64
    a = _data(dt)
    _same_factors(jr.subspace_pca(a, 20), tr.subspace_pca(a, 20,
                                                         device='cpu'), dt)
    for norm, tol in (('f', 0.1), ('m', 0.2), ('s', 0.05)):
        jf = jr.subspace_pca_tol(a, tol, norm=norm)
        tf = tr.subspace_pca_tol(a, tol, norm=norm, device='cpu')
        assert tf[2].shape == jf[2].shape, (norm, tf[2].shape, jf[2].shape)
        _same_factors(jf, tf, dt)
    have = jr.subspace_pca(a[:200], 25)
    for kw in ({'npc': 25}, {'tol': 0.1}):
        jf = jr.subspace_pca_update(have, a[200:], **kw)
        tf = tr.subspace_pca_update(have, a[200:], device='cpu', **kw)
        assert tf[1].shape == jf[1].shape == (M, tf[2].shape[0]), kw
        _same_factors(jf, tf, dt)
    jf = jr.subspace_pca_stream(a, 100, tol=0.1)
    tf = tr.subspace_pca_stream(a, 100, tol=0.1, device='cpu')
    assert tf[2].shape == jf[2].shape
    _same_factors(jf, tf, dt)
    ju, js, jvt = jr.randomized_svd(a, 12)
    tu, ts, tvt = tr.randomized_svd(a, 12, device='cpu')
    _close(ts, js, dt, 'sigma')
    _close((tu * ts) @ tvt, (ju * js) @ jvt, dt, 'u s vt')


def _optimal(a, k):
    s = np.linalg.svd(a - a.mean(axis=0), compute_uv=False)
    return np.sqrt(np.sum(s[k:] ** 2) / np.sum(s ** 2)), s


def test_subspace_pca_matches_optimal_truncation():
    a = _data(np.float32, 600, 400, 200)
    mean, trans, comps = pca(a, npc=40, method='subspace', device='cpu')
    assert comps.shape == (40, 400) and trans.shape == (600, 40)
    em, ef = pca_error(a, mean, trans, comps)
    ef_opt, _ = _optimal(a, 40)
    assert ef <= ef_opt * 1.02
    assert np.abs(comps @ comps.T - np.eye(40)).max() < 5e-3


def test_subspace_pca_tol_adaptive_rank():
    a = _data(np.float64, 600, 400, 200)
    mean, trans, comps = pca(a, tol=0.05, method='subspace', device='cpu')
    em, ef = pca_error(a, mean, trans, comps)
    assert ef <= 0.05
    _, s = _optimal(a, 1)
    tail = np.sqrt(np.maximum(np.sum(s ** 2) - np.cumsum(s ** 2), 0.0))
    k_opt = int(np.searchsorted(-tail, -0.05 * np.sqrt(np.sum(s ** 2))))
    assert comps.shape[0] <= max(2 * k_opt, k_opt + 16)
    mean, trans, comps = pca(a, tol=0.2, norm='s', method='subspace',
                             device='cpu')
    assert np.linalg.norm(trans[:, -1]) <= 0.21 * s[0]


def test_subspace_pca_update_and_stream():
    a = _data(np.float32, 900, 600, 300)
    first = pca(a[:600], tol=0.05, method='subspace', device='cpu')
    mean, trans, comps = pca(a[600:], have=first, tol=0.05,
                             method='subspace', device='cpu')
    assert trans.shape[0] == 900
    em, ef = pca_error(a, mean, trans, comps)
    assert ef < 0.06 and em < 0.06
    mean, trans, comps = pca(a, tol=0.05, batch_size=300, method='subspace',
                             device='cpu')
    assert trans.shape[0] == 900
    em, ef = pca_error(a, mean, trans, comps)
    assert ef < 0.06 and em < 0.06


def test_pca_auto_routes_card_to_subspace(monkeypatch):
    """arch None / 'gpu' / 'cuda' with a non-interactive mode takes the
    subspace engine (method='auto'); arch='cpu' the Jacobi route."""
    calls = []
    real = tr.subspace_pca

    def spy(*args, **kw):
        calls.append(kw.get('device'))
        return real(*args, **kw)
    monkeypatch.setattr(tr, 'subspace_pca', spy)
    a = _data(np.float64, 400, 300, 150)
    for arch in (None, 'gpu', 'cuda'):
        mean, trans, comps = pca(a, npc=30, arch=arch, device='cpu')
        ef_opt, _ = _optimal(a, 30)
        assert pca_error(a, mean, trans, comps)[1] <= ef_opt * 1.02
    assert calls == ['cpu'] * 3
    pca(a, npc=10, arch='cpu')
    assert len(calls) == 3


def test_randomized_svd_sigma():
    np.random.seed(1)
    a, s0, _, _ = tgen.generate(500, 350, 150)
    u, s, vt = tr.randomized_svd(a, 20, device='cpu')
    assert np.abs(s - s0[:20]).max() / s0[0] < 1e-3
    assert np.abs(a @ vt.T - u * s).max() < 1e-3 * s0[0]


def test_fetch_false_keeps_tensors():
    a = _data(np.float32)
    mean, trans, comps = tr.subspace_pca(a, 10, fetch=False, device='cpu')
    assert all(isinstance(t, torch.Tensor) for t in (mean, trans, comps))
    assert mean.shape == (1, N) and trans.shape == (M, 10)
    m2, t2, c2 = tr.subspace_pca(a, 10, device='cpu')
    assert isinstance(c2, np.ndarray)
    assert np.array_equal(c2, comps.numpy())
