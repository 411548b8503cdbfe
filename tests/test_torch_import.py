"""The PyTorch port imports neither jax nor anything of the JAX package:
import it and run its slices (lap3d 10^3 through DIA, a small girder pencil
through ELL and through hand-built BSR operators, the two A/B sweeps of
``raleigh_tpu_torch.benches`` at a small size, the mesh path: a sharded
solve on 8 shards of the CPU, ``ShardedEllMatrix``, the dry run and the
sharded SpMM bench, the core Solver's slice: shift-invert, the product
problem, buckling and engine='core' on dense_torch blocks, the host path
and the example CLIs, and the dense slice: the randomized subspace
engines, truncated_svd, PartialSVD, LRA, pca in its modes on both Jacobi
routes, DeviceJacobi under engine='jacobi', the checkpoint copy and the
pca_demo and truncated_svd_demo CLIs, and the slice of sharded dense
blocks, complex operands, profiling and the image examples) in a fresh
interpreter,
then look at sys.modules.  The port keeps its own copies of the host code
both packages need (the core Solver, ``dense_small``, ``dense_numpy``, the
native LDL^T and its C++ sources, ``spectral_bounds``,
``examples.laplace``, ``examples.fe_model``, ``examples.generate_matrix``,
``utils.checkpoint``), so no module whose top-level name is
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
# the kernel-structure sweeps
from raleigh_tpu_torch.benches import bench_grid_shapes, bench_window_tiles
small = ['--device', 'cpu', '--reps', '1', '--m', '4']
assert len(bench_grid_shapes.main(small + ['--n', '512', '--tiles', '64'])) == 7
for variant in ('ring', 'slide', 'tiles'):
    rows = bench_window_tiles.main([variant, '128'] + small
                                   + ['--grid', '8', '8', '8'])
    assert len(rows) == 2, rows
# the mesh path: operator and blocks split over 8 shards of the CPU
mesh = rt.make_mesh(8, ['cpu'] * 8)
dm = rt.shard_operator(rt.DiaMatrix(a, device='cpu'), mesh)
lo, hi = rt.spectral_bounds(a)
T = rt.Chebyshev(a, lo, hi, degree=10, device_matrix=dm)
lmd, x, resid, niter, status = rt.lobpcg(
    dm, 4, precond=T.device_rows_operands(16), tol=1e-5,
    sharding=rt.blockvec_sharding(mesh))
assert status == 0, status
assert np.abs(lmd - exact).max() / exact[-1] < 1e-4, lmd
sm = rt.ShardedEllMatrix(a, mesh)
xt = np.ones((a.shape[0], 2), dtype=np.float32)
assert np.abs(sm.matmat_t(xt).numpy() - a @ xt).max() < 1e-2
from raleigh_tpu_torch import graft_entry
from raleigh_tpu_torch.benches import bench_spmm_sharded
graft_entry.dryrun_multichip(8, device='cpu')
graft_entry.entry(device='cpu')
bench_spmm_sharded.main(['6', '2', '--device', 'cpu', '--reps', '1'])
# the core Solver's slice: shift-invert (the native LDL^T, built at first
# use), the product problem, buckling and engine='core' on dense_torch
# blocks; the host path; the dense algebra, its selector, the link probe
# and the example CLIs
import scipy.sparse as scs
from raleigh_tpu_torch.algebra import dense, dense_numpy, dense_torch
from raleigh_tpu_torch.examples import buckling_evp, core_solver, sparse_evp
from raleigh_tpu_torch.utils.link import choose_orchestration
a8 = lap3d(8, 8, 8, 1.0, 1.0, 1.0)
ex8 = np.sort(lap3d_eigenvalues(8, 8, 8, 1.0, 1.0, 1.0))[:4]
for kw in ({'device': 'cpu'}, {'arch': 'cpu'}):
    lmd, x, status = rt.partial_hevp(a8, sigma=0, which=4, tol=1e-6,
                                     verb=-1, **kw)
    assert status == 0 and np.allclose(lmd[:4], ex8, rtol=1e-6), lmd
b8 = scs.diags(np.linspace(1.0, 2.0, a8.shape[0]), format='csr')
lmd, x, status = rt.partial_hevp(a8, B=b8, sigma=0, which=3, tol=1e-6,
                                 verb=-1, device='cpu')
assert status == 0, status
lmd, x, status = rt.partial_hevp(a8, B=-b8, buckling=True, sigma=-10.0,
                                 which=2, tol=1e-6, verb=-1, device='cpu')
assert status >= 0, status
T8 = rt.Chebyshev(a8, *rt.spectral_bounds(a8), degree=8, device='cpu')
lmd, x, status = rt.partial_hevp(a8, T=T8, which=4, tol=1e-6, verb=-1,
                                 engine='core', device='cpu')
assert status == 0 and np.allclose(lmd[:4], ex8, rtol=1e-6), lmd
assert choose_orchestration(1000, 16, device='cpu') == 'device'
assert dense.AMatrix(np.eye(3), arch='gpu', device='cpu').backend() \
    is dense_torch
solver, v = core_solver.run(device='cpu')
assert solver.iteration == 58, solver.iteration
sparse_evp.run(4, 0.0, compare_eigsh=False, lap_dims=(6, 6, 6, 1, 1, 1),
               device='cpu')
# the dense slice: the subspace engines, the SVD/LRA/PCA front ends on
# both Jacobi routes (the device engine on dense_torch, the core Solver on
# dense_numpy), engine='jacobi', the checkpoint copy and the demo CLIs
import os
import tempfile
from raleigh_tpu_torch.examples import (generate_matrix, pca_demo,
                                        truncated_svd_demo)
from raleigh_tpu_torch.utils import checkpoint
np.random.seed(1)
A = generate_matrix.generate(200, 120, 60, pca=True)[0]
mean, trans, comps = rt.subspace_pca(A, 10, device='cpu')
assert comps.shape == (10, 120)
assert rt.subspace_pca_tol(A, 0.2, device='cpu')[2].shape[1] == 120
assert rt.randomized_svd(A, 5, device='cpu')[1].shape == (5,)
for kw in ({'device': 'cpu'}, {'arch': 'cpu'}):
    u, s, vt = rt.truncated_svd(A, nsv=5, **kw)
    assert s.shape[0] >= 5, s
    m, l, r = rt.pca(A, npc=8, method='jacobi', **kw)
    em, ef = rt.pca_error(A, m, l, r)
    assert ef < 0.9, ef
    m2, l2, r2 = rt.pca(A[:60], have=(m, l, r), method='jacobi', **kw)
    assert l2.shape[0] == 260, l2.shape
    lra = rt.LowerRankApproximation()
    lra.icompute(A, 100, rank=6, **kw)
    assert lra.right().shape[1] == 120
path = os.path.join(tempfile.mkdtemp(), 'lra.npz')
checkpoint.save_lra(path, mean, trans, comps)
assert checkpoint.load_lra(path)[2].shape == comps.shape
lmd, x, status = rt.partial_hevp(a8, T=T8, which=3, tol=1e-6, verb=-1,
                                 engine='jacobi', device='cpu')
assert status == 0 and np.allclose(lmd[:3], ex8[:3], rtol=1e-5), lmd
assert isinstance(rt.DeviceJacobi, type) and rt.PartialSVD
pca_demo.run('simple', 200, 120, 60, 8, device='cpu')
truncated_svd_demo.run(200, 120, 60, 5, arch='cpu')
# the slice of sharded dense blocks, complex operands, profiling and the
# image examples: the Solver on blocks split over 8 shards of the CPU,
# feature-split subspace_pca, a complex pencil on a device matrix, the
# spans in a trace, the synthetic image set and its converter's masks
import scipy.sparse as scs
import torch
from raleigh_tpu_torch import graft_entry
from raleigh_tpu_torch.examples import convert_images, eigenimages
from raleigh_tpu_torch.parallel.mesh import ShardedRows, matrix_sharding
from raleigh_tpu_torch.utils import profiling
cmesh = rt.make_mesh(8, ['cpu'] * 8)
assert graft_entry._solver_step(cmesh, 128)[0] in (0, 1)
split = ShardedRows.split(torch.from_numpy(A), matrix_sharding(cmesh))
assert rt.subspace_pca(split, 10)[2].shape == (10, 120)
d = 1j * np.ones(199)
hop = scs.csr_matrix(scs.diags(d, 1) - scs.diags(d, -1))
ca = scs.csr_matrix(hop + scs.diags(np.linspace(0, 1, 200)))
cb = scs.csr_matrix(scs.eye(200) + 0.25 * hop)
lmd, x, status = rt.partial_hevp(ca, B=cb, sigma=0.3, which=3, tol=1e-6,
                                 verb=-1, device='cpu')
assert status == 0 and x.dtype == np.complex128, status
logdir = tempfile.mkdtemp()
with profiling.device_trace(logdir):
    with profiling.span('raleigh.import'):
        torch.ones(4).sum()
assert os.path.isfile(os.path.join(logdir, 'trace.json'))
assert eigenimages.synthetic(40, 30, rank=8, device='cpu').shape == (40, 30)
assert convert_images.face_mask(20, 10).shape == (20, 10)
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
