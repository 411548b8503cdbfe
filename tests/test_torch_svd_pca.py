"""The port's dense SVD/PCA stack (``PartialSVD``, ``truncated_svd``,
``LowerRankApproximation`` through ``pca``'s modes, the stopping criteria,
the checkpoint copy) on the CPU against the JAX package's, with the same
NumPy seed, on three routes:

  'jacobi'  the chunked device engine: the port's ``DeviceJacobi`` on
            ``dense_torch`` blocks (``device='cpu'``) against the JAX
            package's on ``dense_jax`` (``arch='tpu'``);
  'host'    the core ``Solver`` on the same device blocks
            (``opt.device_engine='host'``);
  'cpu'     the core ``Solver`` on ``dense_numpy`` (``arch='cpu'``).

f64 data: sigma within 1e-10 relative and the same iteration count; the
vectors within the order of the convergence test they were computed to:
U S V^T within 1e-8 (tolerance 1e-8, or sqrt(eps) = 1.5e-8 in
truncated_svd), the LRA's L R within 1e-6 (its test is looser, with
svtol = 1e-3).  Where the JAX package's device engine locks its pairs as
stagnated before they converge (ROADMAP fault 3.6), the port's is held
against the host SVD instead.
Also ``pca_error`` against the JAX package's doctest bounds at the
BASELINE.md sizes, a checkpoint written by the JAX package resumed by the
port, the interactive stop, and the card default of every entry point.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import raleigh_tpu as J
import raleigh_tpu_torch as T
from raleigh_tpu.algebra import dense_numpy as jnumpy
from raleigh_tpu.algebra.dense import AMatrix as JaxAMatrix
from raleigh_tpu.examples.generate_matrix import generate
from raleigh_tpu.utils import checkpoint as jcheckpoint
from raleigh_tpu_torch.algebra.dense import data_matrix
from raleigh_tpu_torch.interfaces import truncated_svd as tts
from raleigh_tpu_torch.utils import checkpoint as tcheckpoint

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

ROUTES = {'jacobi': ({'arch': 'tpu'}, {'device': 'cpu'}, 'auto'),
          'host': ({'arch': 'tpu'}, {'device': 'cpu'}, 'host'),
          'cpu': ({'arch': 'cpu'}, {'arch': 'cpu'}, 'auto')}


def _data(m=300, n=200, rank=100, pca_mode=False, dt=np.float64):
    np.random.seed(1)
    return generate(m, n, rank, dtype=dt, pca=pca_mode)


def _opt(pkg, engine):
    opt = (J if pkg == 'jax' else T).Options()
    opt.device_engine = engine
    return opt


# vectors agree to the accuracy they converged to, not to rounding; the
# LRA's factors converge to a looser test, res^2 <= (lmd/lmd_max)^1.5
# svtol with svtol = 1e-3
VECTORS = 1e-8
LRA_VECTORS = 1e-6


def _close(got, want, rel=1e-10, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= rel, (what, err)


def _matrix(pkg, a, route):
    jkw, tkw, _ = ROUTES[route]
    if pkg == 'jax':
        return JaxAMatrix(a, arch=jkw['arch'])
    return data_matrix(a, **tkw)


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_partial_svd_matches_jax(route):
    """A tall matrix, and a wide one with the implicit mean shift."""
    for (m, n), shift in (((300, 200), False), ((200, 300), True)):
        a = _data(m, n)[0]
        out = []
        for pkg in ('jax', 'torch'):
            np.random.seed(2)
            mat = _matrix(pkg, a, route)
            psvd = (J if pkg == 'jax' else T).PartialSVD(mat, shift)
            opt = _opt(pkg, ROUTES[route][2])
            opt.convergence_criteria = tts._DefaultSVDConvergenceCriteria(
                1e-8)
            psvd.compute(mat, opt, nsv=(0, 10))
            out.append((psvd.iterations, psvd.sigma, psvd.left(),
                        psvd.right()))
        (ji, js, ju, jv), (ti, ts, tu, tv) = out
        assert ti == ji, (route, m, n, ti, ji)
        _close(ts, js, what='sigma')
        _close((tu * ts) @ tv.T, (ju * js) @ jv.T, VECTORS, 'u s vt')


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_truncated_svd_matches_jax(route):
    """Top 12, and the tolerance-driven mode (Frobenius, 0.2): the same
    number of triplets and the same sigma."""
    a = _data()[0]
    jkw, tkw, engine = ROUTES[route]
    for kw in ({'nsv': 12}, {'nsv': -1, 'tol': 0.2, 'norm': 'f'}):
        out = []
        for fn, pkg, where in ((J.truncated_svd, 'jax', jkw),
                               (T.truncated_svd, 'torch', tkw)):
            np.random.seed(2)
            out.append(fn(a, opt=_opt(pkg, engine), **kw, **where))
        (ju, js, jvt), (tu, ts, tvt) = out
        _close(ts, js, what='sigma %s' % kw)
        _close((tu * ts) @ tvt, (ju * js) @ jvt, VECTORS, 'u s vt')
    sigma0 = np.linalg.svd(a, compute_uv=False)
    assert np.abs(ts - sigma0[:len(ts)]).max() < 1e-6


def _optimal(a, k):
    """The mean, the leading k singular values and their rank-k product
    of the centred a, from the host SVD."""
    mean = a.mean(axis=0, keepdims=True)
    u, s, vt = np.linalg.svd(a - mean, full_matrices=False)
    return mean, s[:k], (u[:, :k] * s[:k]) @ vt[:k]


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_pca_jacobi_modes_match_jax(route):
    """pca(method='jacobi') with npc, tol, have= (LRA update) and
    batch_size= (LRA icompute): the same mean and L R as the JAX package.
    (The tolerance mode runs at tol=0.2 here; test_pca_jacobi_tol_optimal
    holds the device engine at 0.1.)

    The JAX package's update fits the wrong rows on device blocks (ROADMAP
    fault 3.5: it centers the new rows through a view that dense_jax's
    immutable arrays cannot give; its errors here come out above 1).  So
    the update modes are held against its host route, dense_numpy, which
    the port's core Solver routes match; the device engine, which no route
    of the JAX package runs correctly there, is held to the tolerance
    asked.  With npc=15 the JAX package's device engine locks its pairs as
    stagnated before they converge (ROADMAP fault 3.6: sigma 4e-9 and L R
    6e-5 from the host SVD's), so there the device engine is held against
    the host SVD's optimal truncation."""
    a = _data(pca_mode=True)[0]
    jkw, tkw, engine = ROUTES[route]
    np.random.seed(2)
    first = J.pca(a[:200], tol=0.1, method='jacobi',
                  opt=_opt('jax', engine), **jkw)
    for kw in ({'npc': 15}, {'tol': 0.2}, {'have': first, 'tol': 0.1},
               {'batch_size': 100, 'tol': 0.1}):
        update = 'have' in kw or 'batch_size' in kw
        exact = 'npc' in kw and route == 'jacobi'
        rows = slice(200, None) if 'have' in kw else slice(None)
        out = []
        for fn, pkg, where in ((J.pca, 'jax', {'arch': 'cpu'} if update
                                else jkw), (T.pca, 'torch', tkw)):
            if exact and pkg == 'jax':
                continue
            np.random.seed(2)
            out.append(fn(a[rows], method='jacobi', opt=_opt(pkg, engine),
                          **kw, **where))
        tm, tl, tr = out[-1]
        if update and route == 'jacobi':
            em, ef = T.pca_error(a, tm, tl, tr)
            assert ef <= 0.1 and em <= 0.1, (list(kw), em, ef)
            continue
        if exact:
            om, osigma, oproduct = _optimal(a, kw['npc'])
            _close(tm, om, what='mean npc')
            _close(np.linalg.norm(tl, axis=0), osigma, what='sigma npc')
            _close(tl @ tr, oproduct, LRA_VECTORS, 'L R npc')
            continue
        jm, jl, jr = out[0]
        assert tr.shape == jr.shape, (kw, tr.shape, jr.shape)
        _close(tm, jm, what='mean %s' % list(kw))
        # sigma: the column norms of L
        _close(np.linalg.norm(tl, axis=0), np.linalg.norm(jl, axis=0),
               what='sigma %s' % list(kw))
        _close(tl @ tr, jl @ jr, LRA_VECTORS, 'L R %s' % list(kw))


def test_pca_jacobi_tol_optimal():
    """pca(method='jacobi', tol=0.1) on the device engine alone: the
    tolerance met, and the components it returns are the host SVD's
    optimal truncation of that rank (sigma within 1e-10, L R within the
    LRA's 1e-6).  At this tolerance the JAX package's device engine stops
    its pairs short of convergence (ROADMAP fault 3.6: L R 3e-5 from the
    optimum), so no JAX run is compared."""
    a = _data(pca_mode=True)[0]
    np.random.seed(2)
    mean, trans, comps = T.pca(a, tol=0.1, method='jacobi',
                               opt=_opt('torch', 'auto'), device='cpu')
    em, ef = T.pca_error(a, mean, trans, comps)
    assert ef <= 0.1 and em <= 0.1, (em, ef)
    k = comps.shape[0]
    opt_mean, sigma, product = _optimal(a, k)
    _close(mean, opt_mean, what='mean')
    _close(np.linalg.norm(trans, axis=0), sigma, what='sigma')
    _close(trans @ comps, product, LRA_VECTORS, 'L R')


@pytest.mark.parametrize('route', ['cpu', 'host'])
def test_pca_error_pins(route):
    """pca(npc=300) on the seeded generate(3000, 2000, 1000) within the
    doctest's bounds (em < 6e-2, ef < 2e-1; BASELINE.md reads 5e-2 and
    1e-1 for the reference) on the core Solver's routes, which the JAX
    package's doctest runs."""
    a = _data(3000, 2000, 1000, pca_mode=True, dt=np.float32)[0]
    _, tkw, engine = ROUTES[route]
    mean, trans, comps = T.pca(a, npc=300, opt=_opt('torch', engine), **tkw)
    assert comps.shape == (300, 2000)
    em, ef = T.pca_error(a, mean, trans, comps)
    assert em < 6e-2 and ef < 2e-1, (em, ef)


def test_checkpoint_from_jax_resumes_in_port(tmp_path):
    """(mean, L, R) of the JAX package's pca, saved by its checkpoint
    module, load in the port's and warm-start the port's pca(have=):
    the JAX package's own update to 1e-10."""
    a = _data(pca_mode=True)[0]
    np.random.seed(2)
    first = J.pca(a[:200], tol=0.1, arch='cpu')
    path = str(tmp_path / 'lra.npz')
    jcheckpoint.save_lra(path, *first)
    have = tcheckpoint.load_lra(path)
    for x, y in zip(have, first):
        assert np.array_equal(x, y)
    out = []
    for fn in (J.pca, T.pca):
        np.random.seed(3)
        out.append(fn(a[200:], have=tuple(np.copy(h) for h in have),
                      arch='cpu'))
    (jm, jl, jr), (tm, tl, tr) = out
    _close(tm, jm)
    _close(np.linalg.norm(tl, axis=0), np.linalg.norm(jl, axis=0))
    _close(tl @ tr, jl @ jr, LRA_VECTORS)
    # and eigenpairs saved by the JAX package's Solver
    v = jnumpy.Vectors(50, data_type=np.float64)
    solver = J.Solver(J.Problem(v, jnumpy.Matrix(np.diag(np.arange(
        1.0, 51.0)))))
    assert solver.solve(v, J.Options(), which=(3, 0)) == 0
    jcheckpoint.save_eigenpairs(str(tmp_path / 'eig.npz'), solver, v)
    lmd, tv, info = tcheckpoint.load_eigenpairs(str(tmp_path / 'eig.npz'))
    assert np.array_equal(lmd, solver.eigenvalues)
    assert np.array_equal(tv.data(), v.data())
    assert int(info['iteration']) == solver.iteration


@pytest.mark.parametrize('route', ['cpu', 'jacobi'])
def test_interactive_stop(monkeypatch, route):
    """truncated_svd(nsv=-1, tol=0) asks once per converged batch; 'n'
    stops the run; k is the count the last prompt reported.  No bound on k
    is assumed: a batch may converge everything left at once (ROADMAP
    fault 3.1).  On the host route the JAX package asks the same
    questions; its device engine stops with an IndexError on this run
    (ROADMAP fault 3.4), so the 'jacobi' route is held alone."""
    a = _data(400, 300, 150)[0]
    jkw, tkw, _ = ROUTES[route]
    runs = []
    for fn, where in ((T.truncated_svd, tkw), (J.truncated_svd, jkw)):
        if fn is J.truncated_svd and route == 'jacobi':
            break
        prompts = []
        answers = iter(['', '', 'n'])

        def ask(msg):
            prompts.append(msg)
            return next(answers, 'n')
        monkeypatch.setattr('builtins.input', ask)
        np.random.seed(1)
        u, sigma, vt = fn(a, nsv=-1, tol=0, **where)
        idx = [int(p.split('sigma[')[1].split(']')[0]) for p in prompts]
        runs.append((idx, sigma))
        assert 1 <= len(prompts) <= 3           # none after the 'n'
        assert idx == sorted(set(idx))          # one prompt per batch
        assert sigma.shape[0] == idx[-1] + 1    # k at the last prompt
    if len(runs) == 2:
        (tidx, ts), (jidx, js) = runs
        assert tidx == jidx
        _close(ts, js)


@pytest.mark.parametrize('route', ['cpu', 'jacobi'])
def test_user_stopping_criteria(route):
    """UserStoppingCriteria recomputes (U, Sigma) from the converged
    vectors on every check and stops when its probe says so."""
    a, s0, _, _ = _data(400, 300, 150, dt=np.float32)
    calls = []

    class Probe:
        def inspect(self, mean, sigma, left, right):
            calls.append(sigma.shape[0])
            return sigma.shape[0] >= 20

    opt = T.Options()
    opt.block_size = 16
    opt.stopping_criteria = tts.UserStoppingCriteria(a, probe=Probe())
    mat = _matrix('torch', a, route)
    T.PartialSVD(mat).compute(mat, opt, nsv=(0, -1))
    assert calls and calls[-1] >= 20
    assert np.allclose(opt.stopping_criteria.sigma[:10], s0[:10],
                       rtol=1e-3)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, every new entry point raises unless arch='cpu' or
    device='cpu' asks for the host."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    a = _data(60, 40, 20, pca_mode=True)[0]
    from raleigh_tpu_torch.examples.laplace import lap3d
    lap = lap3d(4, 4, 4, 1.0, 1.0, 1.0)
    calls = [lambda: T.truncated_svd(a, nsv=3),
             lambda: T.pca(a, npc=3),
             lambda: T.pca(a, npc=3, method='jacobi'),
             lambda: T.subspace_pca(a, 3),
             lambda: T.subspace_pca_tol(a, 0.1),
             lambda: T.randomized_svd(a, 3),
             lambda: T.LowerRankApproximation().icompute(a, 20, rank=3),
             lambda: T.partial_hevp(lap, T=np.eye(64), which=2,
                                    engine='jacobi', verb=-1)]
    for call in calls:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
    assert T.truncated_svd(a, nsv=3, arch='cpu')[1].shape[0] >= 3
    assert T.pca(a, npc=3, device='cpu')[2].shape == (3, 40)
