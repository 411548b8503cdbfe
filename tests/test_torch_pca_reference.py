"""The port's dense PCA (``pca``, on the subspace engine) against a plain
float64 reference that imports nothing of the port or of JAX
(``tests/reference_pca.py``, the benchmark's ``references/pca64.py``), on
the CPU at a small size of the benchmark's synthetic eigenimages recipe
(``portbench/makers/lfw_synthetic.py``): 600 x 2,000, rank 256, 40
components.  Also the engine's spans and counts (``interfaces/
randomized.py``: ``raleigh.subspace*``, ``COUNTS``) under one call.

The three checks are the benchmark's (``portbench/tasks/pca.py``):
``err_excess``, the Frobenius error of mean + trans comps over the optimal
rank-40 error, less 1; ``sv_err``, the largest relative gap of trans's
column norms from the reference's singular values; ``ortho``, the largest
entry of |comps comps^T - I|; ``trans_ortho``, the same of trans with
unit columns (the left singular vectors).
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reference_pca
from portbench.makers import lfw_synthetic
from raleigh_tpu_torch.interfaces import randomized
from raleigh_tpu_torch.interfaces.pca import pca
from raleigh_tpu_torch.utils import profiling

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
COPIES = (ROOT / 'tests' / 'reference_pca.py',
          ROOT / 'portbench' / 'references' / 'pca64.py')
M, N, RANK, NPC = 600, 2000, 256, 40
PARAMS = {'m': M, 'n': N, 'rank': RANK, 'alpha': 0.75, 'noise': 1e-5,
          'device': 'cpu'}
SEED = 2 ** 31 + 41

# Each tolerance is a bound of f32 arithmetic at this size, with room
# (readings on three seeds of this host):
# - err_excess: l = 104 subspace vectors for 40 components and 7 powers of
#   G leave the subspace's error far below f32's rounding, and the error is
#   stationary at the optimum, so the factors' f32 rounding moves it at
#   second order only (read 1e-11 to 3e-11);
# - sv_err: the f32 Gram's rounding, eps_f32 lambda_1 (eps_f32 = 6e-8),
#   moves lambda_40 by about eps_f32 lambda_1 / lambda_40 ~ 5e-6 of itself,
#   sigma_40 by half that (read 6e-7 to 1.0e-6);
# - ortho: comps = As^T u / sigma carries the same rounding into
#   comps comps^T at the tail (read 2e-6 to 7e-6);
# - trans_ortho: u = q w, both orthonormal, is orthonormal to the rounding
#   of an f32 product of 104 terms (read 5.1e-7 to 5.6e-7).
# Products rounded as TF32 takes them (10 mantissa bits, eps 4.9e-4) read
# 7.0e-7 to 7.6e-7, 2.2e-4 to 2.6e-4, 4.1e-4 to 6.4e-4 and 2.6e-4 to
# 3.7e-4: each fails.
TOL = {'err_excess': 1e-8, 'sv_err': 1e-5, 'ortho': 5e-5,
       'trans_ortho': 1e-5}


@pytest.fixture(scope='module')
def data():
    return lfw_synthetic.make(PARAMS, SEED)['A']


@pytest.fixture(scope='module')
def ref(data):
    return reference_pca.spectrum(data, NPC, 'cpu')


def _readings(a, x, ref):
    """The four checks of the factors ``x`` in float64."""
    mean, trans, comps = (np.asarray(t, dtype=np.float64) for t in x)
    err = np.linalg.norm(np.asarray(a, dtype=np.float64) - mean
                         - trans @ comps)
    sv = np.linalg.norm(trans, axis=0)
    u = trans / sv
    eye = np.eye(len(sv))
    return {'err_excess': err / ref['e_opt'] - 1.0,
            'sv_err': float(np.max(np.abs(sv - ref['sigma'])
                                   / ref['sigma'])),
            'ortho': float(np.abs(comps @ comps.T - eye).max()),
            'trans_ortho': float(np.abs(u.T @ u - eye).max())}


def _pca(a):
    return pca(a, npc=NPC, method='subspace', device='cpu')


@pytest.mark.parametrize('check', sorted(TOL))
def test_pca_is_held_to_the_reference(data, ref, check):
    x = _pca(data)
    assert [np.shape(t) for t in x] == [(1, N), (M, NPC), (NPC, N)]
    assert all(t.dtype == np.float32 for t in x)
    value = _readings(data, x, ref)[check]
    assert -1e-9 <= value <= TOL[check], (check, value)


def _tf32(x):
    """x with its f32 mantissas rounded to TF32's 10 bits."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def test_products_rounded_as_tf32_fail_a_check(data, ref, monkeypatch):
    """Every product of the engine with its operands rounded to 10
    mantissa bits, as TF32 takes them, fails a tolerance."""
    matmul = torch.matmul
    monkeypatch.setattr(torch, 'matmul',
                        lambda x, y: matmul(_tf32(x), _tf32(y)))
    got = _readings(data, _pca(data), ref)
    failed = [k for k in TOL if got[k] > TOL[k]]
    assert failed, got
    assert got['trans_ortho'] > 10 * TOL['trans_ortho'], got


def test_the_reference_is_the_centred_svd(data, ref):
    """The reference's sigma and e_opt are those of LAPACK's SVD of the
    centred data in float64, within float64's rounding of the Gram."""
    x = np.asarray(data, dtype=np.float64)
    s = np.linalg.svd(x - x.mean(axis=0), compute_uv=False)
    assert np.allclose(ref['sigma'], s[:NPC], rtol=1e-9, atol=0)
    assert ref['e_opt'] == pytest.approx(np.sqrt(np.sum(s[NPC:] ** 2)),
                                         rel=1e-8)
    assert ref['norm'] == pytest.approx(np.sqrt(np.sum(s ** 2)), rel=1e-12)


def _load(path):
    spec = importlib.util.spec_from_file_location('ref_' + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_two_copies_of_the_reference_agree(data):
    """The benchmark's copy is the tests' copy but for its docstring, and
    gives the same numbers."""
    bodies = [[ast.dump(node) for node in ast.parse(p.read_text()).body[1:]]
              for p in COPIES]
    assert bodies[0] == bodies[1]
    one, two = (_load(p).spectrum(data, NPC, 'cpu') for p in COPIES)
    assert np.array_equal(one['sigma'], two['sigma'])
    assert one['e_opt'] == two['e_opt']


@pytest.mark.parametrize('path', COPIES, ids=lambda p: p.name)
def test_the_reference_imports_neither_jax_nor_the_port(path):
    """Its imports are numpy and torch alone, and loading it in a fresh
    interpreter loads no module of JAX, raleigh_tpu or raleigh_tpu_torch."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, 'a relative import'
            tops.add(node.module.split('.')[0])
    assert tops == {'numpy', 'torch'}
    code = ('import importlib.util, sys\n'
            'spec = importlib.util.spec_from_file_location("ref", %r)\n'
            'spec.loader.exec_module(importlib.util.module_from_spec(spec))\n'
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"jax", "jaxlib", "raleigh_tpu", "raleigh_tpu_torch", '
            '"portbench"}))\n' % str(path))
    done = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == '[]'


def test_the_maker_draws_from_the_seed():
    """The same seed gives the same matrix, another seed another; the
    column of ones in the left factor is a constant direction, which
    centring takes out: the leading singular value, 1 before, falls to
    near the second, 2^-0.75 = 0.59."""
    small = dict(PARAMS, m=64, n=200, rank=32)
    one = lfw_synthetic.make(small, SEED)['A']
    assert one.shape == (64, 200) and one.dtype == torch.float32
    assert torch.equal(one, lfw_synthetic.make(small, SEED)['A'])
    assert not torch.equal(one, lfw_synthetic.make(small, SEED + 1)['A'])
    x = one.double()
    s = torch.linalg.svdvals(x)
    c = torch.linalg.svdvals(x - x.mean(dim=0))
    assert s[0] > 0.9 and c[0] < 0.8


def _spans(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith('raleigh.')),
                  key=lambda x: (x[1], -x[2]))


def test_the_engine_spans_nest_as_named(data):
    """One pca call: raleigh.pca holds one raleigh.subspace, which holds
    the Gram, seven iterations, the Rayleigh-Ritz step, the factors and
    the fetch to the host, in that order."""
    found = _spans(lambda: _pca(data))
    names = [n for n, _, _ in found]
    assert names == (['raleigh.pca', 'raleigh.subspace',
                      'raleigh.subspace.gram']
                     + ['raleigh.subspace.iterate'] * 7
                     + ['raleigh.subspace.rr', 'raleigh.subspace.factors',
                        'raleigh.sync'])
    (_, s0, e0), (_, s1, e1) = found[:2]
    assert s0 <= s1 and e1 <= e0
    for _, s, e in found[2:]:
        assert s1 <= s and e <= e1
    # the steps follow one another
    ends = [e for _, _, e in found[2:-1]]
    starts = [s for _, s, _ in found[3:]]
    assert all(e <= s for e, s in zip(ends, starts))


def test_no_span_opens_without_a_profiler(data, monkeypatch):
    opened = []

    def recording(name):
        opened.append(name)
        return profiling.contextlib.nullcontext()
    monkeypatch.setattr(profiling, '_RecordFunctionFast', recording)
    _pca(data)
    assert opened == []


def test_the_counts_of_one_call(data):
    """One pca call: one engine call, 13 products (A mean, A A^T, 8 G q,
    q^T (G q), q w, A^T u), 7 QRs, one eigh, and the factors' bytes,
    none of them through pinned memory on the CPU."""
    randomized.reset_counts()
    _pca(data)
    assert randomized.COUNTS == {
        'calls': 1, 'products': 13, 'qr': 7, 'eigh': 1,
        'to_host_bytes': 4 * (N + M * NPC + NPC * N), 'pinned_bytes': 0}
    randomized.reset_counts()
    assert set(randomized.COUNTS.values()) == {0}
