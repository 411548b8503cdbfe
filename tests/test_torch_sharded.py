"""The mesh path of the PyTorch port against the JAX package, on the CPU:
the extended-operand DIA apply, the strided copy and its batched form, the
mesh and its sharded row blocks, ``shard_operator``, the mesh DIA apply and
its piece table, the sharded ``lobpcg`` with a sharded Chebyshev
preconditioner, ``ShardedEllMatrix``, the dry run and the sharded SpMM
bench.

Inputs are seeded NumPy arrays at small sizes.  The JAX side runs on the 8
virtual CPU devices ``tests/conftest.py`` provides, its Pallas kernels in
interpret mode.  The port runs on a mesh of 8 shards of the CPU
(``make_mesh(8, ['cpu'] * 8)``), where every wrapper takes its kernel's
plain version.

Tolerances.  f32 DIA applies: 1e-6 of the largest |entry| (f32 sums of 5
terms, the packages round in different orders); f64: 1e-12 to 1e-13.  The
port's sharded apply (the mesh apply's plain version over the piece table,
and the per-shard route over copied extended operands) against its own
unsharded one: exact equality (a term outside the matrix adds 0
instead of being skipped).  Copies: exact.
Eigenvalues of both packages from one start block in f64: 1e-8 relative,
iteration counts equal (whole chunks of 16).
"""

import numpy as np
import pytest
import scipy.sparse as scs
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from raleigh_tpu.algebra.sparse import Chebyshev as JaxChebyshev
from raleigh_tpu.algebra.sparse import spectral_bounds
from raleigh_tpu.core.device_solver import lobpcg as jax_lobpcg
from raleigh_tpu.core.device_solver import shard_operator as jax_shard
from raleigh_tpu.examples.laplace import (lap1d, lap2d, lap3d,
                                          lap3d_eigenvalues)
from raleigh_tpu.ops import spmm as jax_spmm
from raleigh_tpu.ops.spmm_window import build_dia_window_ring_ext
from raleigh_tpu.parallel import mesh as jax_mesh
from raleigh_tpu.parallel.spmm_sharded import ShardedEllMatrix as JaxSharded
from raleigh_tpu_torch import graft_entry
from raleigh_tpu_torch.algebra.sparse import Chebyshev
from raleigh_tpu_torch.benches import (bench_grid_shapes, bench_launch_cost,
                                       bench_spmm_sharded)
from raleigh_tpu_torch.core.device_solver import lobpcg, shard_operator
from raleigh_tpu_torch.examples import fe_model as fe
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.ops import stream as st
from raleigh_tpu_torch.ops.spmm import (BsrMatrix, DiaMatrix, EllMatrix,
                                        device_sparse)
from raleigh_tpu_torch.parallel.mesh import (AXIS, HOST_AXIS, ShardedRows,
                                             Sharding, blockvec_sharding,
                                             make_mesh, make_mesh2d,
                                             matrix_sharding, replicated,
                                             ring_extended)
from raleigh_tpu_torch.parallel.spmm_sharded import ShardedEllMatrix

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

CPUS = ['cpu'] * 8


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope='module')
def mesh():
    return make_mesh(8, CPUS)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _lap2d_4096():
    """The case of tests/test_sharded.py: 8 shards of 512 lanes."""
    return scs.csr_matrix(lap2d(64, 64, 1.0, 1.0))[:4096, :4096]


# ---- K4: the extended-operand DIA apply -------------------------------

@pytest.mark.parametrize('dtype,tol', [(np.float32, 1e-6),
                                       (np.float64, 1e-13)])
def test_ext_apply_matches_jax(dtype, tol):
    """One shard's apply, n = 512 lanes with lap2d's offsets: the port's
    wrapper against the Pallas kernel in interpret mode (f32 only, halos
    rounded up to 128 lanes, tile 256) and against the fused XLA version
    on the same x_ext and val."""
    n, m = 512, 8
    jd = jax_spmm.DiaMatrix(_lap2d_4096(), dtype=dtype)
    offsets = tuple(jd.offsets)
    rng = np.random.RandomState(3)
    val = np.asarray(jd.val)[:, 1024:1024 + n].astype(dtype)
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    call, w_lo, w_hi, npad = build_dia_window_ring_ext(offsets, n, m,
                                                       tile=256,
                                                       interpret=True)
    assert (w_lo, w_hi, npad) == (128, 128, 512) and lo == hi == 64
    x_ext = rng.standard_normal((m, w_lo + n + w_hi)).astype(dtype)
    tv, tx = torch.from_numpy(val), torch.from_numpy(x_ext)
    offs_t = torch.tensor(offsets, dtype=torch.int32)
    got = sw.dia_matmat_rows_ext(tv, tx, offs_t, w_lo, n)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    fused = jax_spmm._dia_matmat_rows_ext(jnp.asarray(val),
                                          jnp.asarray(x_ext), offsets, w_lo,
                                          n)
    assert _rel(got.numpy(), fused) <= tol
    if dtype == np.float32:
        window = call(jnp.asarray(x_ext), jnp.asarray(val))[:, :n]
        assert _rel(got.numpy(), window) <= tol
    # exact halos, a strided operand and the host-side reach give one result
    exact = tx[:, w_lo - lo:w_lo + n + hi]
    assert not exact.is_contiguous()
    again = sw.dia_matmat_rows_ext(tv, exact, offs_t, lo, n, reach=(lo, hi))
    assert torch.equal(again, got)
    assert torch.equal(got, sw.dia_matmat_rows_ext_plain(tv, tx, offsets,
                                                         w_lo, n))


def test_ext_apply_checks_run_on_the_cpu():
    offs = torch.tensor([-3, 0, 5], dtype=torch.int32)
    val, x = torch.zeros((3, 10)), torch.zeros((4, 18))
    assert sw.dia_matmat_rows_ext(val, x, offs, 3, 10).shape == (4, 10)
    with pytest.raises(ValueError, match='reach 3 before'):
        sw.dia_matmat_rows_ext(val, x, offs, 2, 10)
    with pytest.raises(ValueError, match='5 after'):
        sw.dia_matmat_rows_ext(val, x[:, :17], offs, 3, 10)
    with pytest.raises(ValueError, match='shape'):
        sw.dia_matmat_rows_ext(val, x, offs, 3, 9)
    with pytest.raises(ValueError, match='shape'):
        sw.dia_matmat_rows_ext(val, x, offs[:2], 3, 10)
    assert set(sw.LAUNCHES) >= {'ext_float32', 'ext_bfloat16'}
    assert sw.LAUNCHES['ext_float32'] == 0      # no kernel on the CPU


# ---- K9: the strided copy ---------------------------------------------

@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int32,
                                   np.uint8])
@pytest.mark.parametrize('rows,width,src_off,dst_off', [
    (16, 1000, 150, 0), (5, 1001, 7, 11), (1, 33, 0, 2), (3, 1, 2, 2)])
def test_copy_lanes_matches_numpy(rows, width, src_off, dst_off, dtype):
    src = (np.random.RandomState(4).standard_normal((rows, 2000)) * 50
           ).astype(dtype)
    want = np.zeros((rows, 1500), dtype)
    want[:, dst_off:dst_off + width] = src[:, src_off:src_off + width]
    got = torch.zeros((rows, 1500), dtype=torch.from_numpy(want).dtype)
    out = st.copy_lanes(got[:, dst_off:dst_off + width],
                        torch.from_numpy(src)[:, src_off:src_off + width])
    assert out.data_ptr() == got[:, dst_off:].data_ptr()
    assert np.array_equal(got.numpy(), want)
    # 1-D views, and bf16
    one = torch.zeros(width, dtype=got.dtype)
    st.copy_lanes(one, torch.from_numpy(src)[0, src_off:src_off + width])
    assert np.array_equal(one.numpy(), src[0, src_off:src_off + width])


@pytest.mark.parametrize('count', [24, st.COPY_MAX + 4])
def test_copy_lanes_many_matches_numpy(count):
    """A batch of copies of mixed dtypes, widths, row counts and alignments
    (1-D and 2-D views, source and slot shifted by odd element counts) in
    one call, more copies than one launch takes among them: the plain
    version equals NumPy, and nothing outside the slots is written."""
    rng = np.random.RandomState(count)
    dtypes = [np.float32, np.float64, np.int32, np.uint8, np.int16]
    pairs, wants, gots = [], [], []
    for i in range(count):
        dtype = dtypes[i % len(dtypes)]
        rows, width = 1 + i % 4, 1 + rng.randint(300)
        src_off, dst_off = rng.randint(17), rng.randint(13)
        src = (rng.standard_normal((rows, 400)) * 50).astype(dtype)
        want = np.zeros((rows, 350), dtype)
        want[:, dst_off:dst_off + width] = src[:, src_off:src_off + width]
        got = torch.zeros((rows, 350), dtype=torch.from_numpy(want).dtype)
        dst, view = (got[:, dst_off:dst_off + width],
                     torch.from_numpy(src)[:, src_off:src_off + width])
        if rows == 1 and i % 2:
            dst, view = dst[0], view[0]
        pairs.append((dst, view))
        wants.append(want)
        gots.append(got)
    st.copy_lanes_many(pairs)
    for got, want in zip(gots, wants):
        assert np.array_equal(got.numpy(), want)
    assert st.LAUNCHES['copy_lanes'] == 0       # no kernel on the CPU


@pytest.mark.parametrize('m,n,tile', [(8, 1024, 128), (5, 1000, 8),
                                      (3, 999, 999), (1, 16, 4)])
def test_hbm2hbm_matches_jax(m, n, tile):
    """The reference's kernel under ``force_tpu_interpret_mode`` (where its
    shape allows: whole tiles) and NumPy: exact equality."""
    import importlib.util
    import os
    from jax.experimental.pallas import tpu as pltpu
    x = np.random.RandomState(9).standard_normal((m, n)).astype(np.float32)
    y = st.hbm2hbm(torch.from_numpy(x), tile)
    assert y.data_ptr() != torch.from_numpy(x).data_ptr()
    assert np.array_equal(y.numpy(), x)
    assert np.array_equal(
        st.hbm2hbm(torch.from_numpy(x).bfloat16(), tile).float().numpy(),
        torch.from_numpy(x).bfloat16().float().numpy())
    if (m, n, tile) == (8, 1024, 128):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            'jax_bench_grid_shapes',
            os.path.join(root, 'benches', 'bench_grid_shapes.py'))
        jb = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jb)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jb.build_hbm2hbm(m, n, tile)(x))
        assert np.array_equal(y.numpy(), want)


def test_copy_checks_run_on_the_cpu():
    x = torch.zeros((4, 100))
    with pytest.raises(TypeError, match='converts nothing'):
        st.copy_lanes(torch.zeros((4, 100), dtype=torch.float64), x)
    with pytest.raises(ValueError, match='one shape'):
        st.copy_lanes(torch.zeros((4, 99)), x)
    with pytest.raises(ValueError, match='one shape'):
        st.copy_lanes(torch.zeros((2, 2, 100)), torch.zeros((2, 2, 100)))
    with pytest.raises(ValueError, match='unit stride'):
        st.copy_lanes(torch.zeros((100, 4)).T, x)
    with pytest.raises(ValueError, match='device'):
        st.copy_lanes(torch.zeros((4, 100), device='meta'), x)
    with pytest.raises(TypeError, match='elements of'):
        st.copy_lanes(torch.zeros((4, 100), dtype=torch.complex128),
                      torch.zeros((4, 100), dtype=torch.complex128))
    with pytest.raises(ValueError, match='multiple of tile'):
        st.hbm2hbm(x, 33)
    with pytest.raises(ValueError, match='2-D'):
        st.hbm2hbm(x[0], 10)
    with pytest.raises(ValueError, match='one device'):
        st.copy_lanes_many([(torch.zeros(3), torch.ones(3)),
                            (torch.zeros(3, device='meta'),
                             torch.ones(3, device='meta'))])
    with pytest.raises(TypeError, match='converts nothing'):
        st.copy_lanes_many([(torch.zeros(3), torch.ones(3)),
                            (torch.zeros(3), torch.ones(3).double())])
    st.copy_lanes_many([])
    assert st.LAUNCHES['copy_lanes'] == 0       # no kernel on the CPU


# ---- the mesh and its sharded row blocks -------------------------------

def test_meshes_mirror_the_jax_package():
    jm, jm2 = jax_mesh.make_mesh(8), jax_mesh.make_mesh2d(2, 4)
    m1, m2 = make_mesh(8, CPUS), make_mesh2d(2, 4, CPUS)
    assert (AXIS, HOST_AXIS) == (jax_mesh.AXIS, jax_mesh.HOST_AXIS)
    assert m1.axis_names == tuple(jm.axis_names)
    assert m2.axis_names == tuple(jm2.axis_names)
    assert m1.shape == dict(jm.shape) and m2.shape == dict(jm2.shape)
    assert m2.devices.shape == jm2.devices.shape == (2, 4)
    assert make_mesh(3, CPUS).size == 3
    assert make_mesh(devices=CPUS[:5]).size == 5
    sh = blockvec_sharding(m2)
    assert sh.nshards == 8 and sh.groups == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert blockvec_sharding(m1).groups == [list(range(8))]
    assert matrix_sharding(m1).same_layout(blockvec_sharding(m1))
    assert replicated(m1).nshards == 1
    assert Sharding(m2, AXIS).nshards == 4
    # the spec JAX gives a block vector names the same axes
    assert tuple(jax_mesh.blockvec_sharding(jm2).spec)[1] == sh.axes
    with pytest.raises(ValueError, match='needs|asked for'):
        make_mesh2d(2, 8, CPUS)
    with pytest.raises(ValueError, match='axes'):
        Sharding(m1, 'chips')
    assert sh.bounds(10) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10),
                             (10, 10), (10, 10), (10, 10)]


def test_mesh_defaults_to_the_card():
    """No device named: shards of the card, and an error without one."""
    if torch.cuda.is_available():
        assert all(d.type == 'cuda' for d in make_mesh(8).devices.ravel())
        return
    for build in (lambda: make_mesh(8), make_mesh,
                  lambda: make_mesh2d(2, 4),
                  lambda: graft_entry.dryrun_multichip(8),
                  graft_entry.entry,
                  lambda: bench_spmm_sharded.main(['6', '2']),
                  lambda: bench_launch_cost.main(['--reps', '1']),
                  lambda: bench_grid_shapes.main(['hbm2hbm', '--n', '64',
                                                  '--tiles', '8'])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()


@pytest.mark.parametrize('grid', ['1-D', '2-D'])
@pytest.mark.parametrize('n', [4096, 1003, 5])
def test_sharded_rows_match_the_whole_tensor(f64_default, grid, n):
    """Every operation the solver applies to a block, on the shards and on
    the gathered tensor: f64, 1e-13."""
    mesh = make_mesh(8, CPUS) if grid == '1-D' else make_mesh2d(2, 4, CPUS)
    sh = blockvec_sharding(mesh)
    rng = np.random.RandomState(n)
    a, b = rng.standard_normal((2, 6, n))
    sa, sb = ShardedRows.split(a, sh), ShardedRows.split(b, sh)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert sa.shape == ta.shape and sa.dtype == ta.dtype
    assert len(sa.parts) == 8 and all(p.is_contiguous() for p in sa.parts)
    assert torch.equal(sa.gather(), ta)
    assert torch.equal(ShardedRows.split(ta, sh).gather(), ta)
    assert sa.bounds() == sh.bounds(n)

    def close(got, want):
        got = got.gather() if isinstance(got, ShardedRows) else got
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-13 * max(1, want.abs().max())

    close(sa.gram(sb), ta @ tb.T)
    close(sa.row_dots(sb), (ta * tb).sum(1))
    close(sa.row_norms(), torch.linalg.vector_norm(ta, dim=1))
    c = torch.from_numpy(rng.standard_normal((4, 6)))
    close(sa.mixed(c), c @ ta)
    col = torch.from_numpy(rng.standard_normal((6, 1)))
    close(sa + sb, ta + tb)
    close(sa - sb, ta - tb)
    close(sa * col, ta * col)
    close(2.5 * sa, 2.5 * ta)
    close(sa / col, ta / col)
    close(sa / 3.0, ta / 3.0)
    close(sa.conj(), ta)
    assert sa.real.dtype == torch.float64
    dead = torch.tensor([False, True, False, False, True, False])
    close(sa.zero_rows(dead), torch.where(dead[:, None], 0.0, ta))
    order = torch.tensor([3, 0, 5, 1, 2, 4])
    close(sa[order], ta[order])
    close(sa[:4], ta[:4])
    close(sa[dead], ta[dead])
    close(ShardedRows.cat((sa, sb, sa)), torch.cat((ta, tb, ta)))
    close(sa.zeros_like(), torch.zeros_like(ta))
    assert sa.to(torch.float32).dtype == torch.float32
    assert sa.to(torch.float64) is sa and sa.contiguous() is sa
    close(sa.resplit(Sharding(make_mesh(3, CPUS), AXIS)), ta)
    # the halo assembly: own lanes between the neighbours', ring-wrapped
    exts, copies = ring_extended(sa, 3, 2)
    for (s, e), ext in zip(sa.bounds(), exts):
        if s == e:
            assert ext is None
            continue
        lanes = np.arange(s - 3, e + 2) % n
        assert np.array_equal(ext.numpy(), a[:, lanes])
    assert copies >= 3 * sum(e > s for s, e in sa.bounds())


# ---- shard_operator and the sharded DIA apply ---------------------------

@pytest.mark.parametrize('dtype,tol', [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_sharded_dia_apply_matches_jax(mesh, f64_default, dtype, tol):
    """n = 8 x 512 (tests/test_sharded.py:222-257): the port's sharded
    apply against JAX's through both of its per-shard kernels and SciPy,
    and equal to the port's own unsharded apply."""
    a = _lap2d_4096()
    n = a.shape[0]
    x = np.random.RandomState(11).randn(4, n).astype(dtype)
    ref = (a @ x.T).T
    jmesh = jax_mesh.make_mesh(8)
    jdm = jax_shard(jax_spmm.DiaMatrix(a, dtype=dtype), jmesh,
                    axis=jax_mesh.AXIS)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(
        jmesh, P(None, jax_mesh.AXIS)))
    wants = [np.asarray(jdm.sharded_rows_fn(4, n, dtype=dtype,
                                            force_window=False)(xs))]
    if dtype == np.float32:
        wants.append(np.asarray(jdm.sharded_rows_fn(
            4, n, tile=256, interpret=True, force_window=True)(xs)))

    whole = DiaMatrix(a, dtype=dtype, device='cpu')
    dm = shard_operator(DiaMatrix(a, dtype=dtype, device='cpu'), mesh)
    assert dm._multi_device() and not whole._multi_device()
    assert whole.sharded_rows_fn(4, n) is None
    sh = blockvec_sharding(mesh)
    tx = torch.from_numpy(x)
    fn = dm.sharded_rows_fn(4, n, tx.dtype)
    before = dict(sw.LAUNCHES), dict(st.LAUNCHES)
    y = fn(ShardedRows.split(tx, sh))
    assert (dict(sw.LAUNCHES), dict(st.LAUNCHES)) == before
    assert isinstance(y, ShardedRows) and y.dtype == tx.dtype
    assert [p.shape for p in y.parts] == [(4, 512)] * 8
    got = y.gather()
    for want in wants + [ref]:
        assert _rel(got.numpy(), want) <= tol
    assert torch.equal(got, whole.matmat_rows(tx))
    # matmat_rows and the operand forms take the same route
    assert torch.equal(dm.matmat_rows(ShardedRows.split(tx, sh)).gather(),
                       got)
    assert torch.equal(dm.matmat_rows(tx), got)     # a whole tensor, too
    assert torch.equal(dm.matmat_t(tx.T.contiguous()).T, got)
    assert torch.equal(fn.operand_fn(dm.val, ShardedRows.split(tx, sh))
                       .gather(), got)
    opfn, ops = dm.rows_operand_form()
    assert torch.equal(opfn(ops, ShardedRows.split(tx, sh)).gather(), got)
    # the mesh apply's plain version over the partition's piece table: one
    # launch group, three pieces a shard, the same floats
    plan = dm._mesh_plan(dm.val.sharding)
    assert len(plan.launches) == 1 and [len(p) for p in plan.pieces] == [3] * 8
    parts = sw.dia_matmat_rows_mesh_plain(
        dm.val.parts, ShardedRows.split(tx, sh).parts, plan)
    for want in wants:
        assert _rel(torch.cat(parts, dim=1).numpy(), want) <= tol
    assert torch.equal(torch.cat(parts, dim=1), got)


@pytest.mark.parametrize('case', ['uneven', 'wide reach', 'one shard',
                                  '2 x 4 mesh', 'empty shards',
                                  'from_arrays', 'bf16'])
def test_sharded_dia_apply_takes_any_partition(case):
    """Where JAX's explicit path returns None (n not a multiple of the
    shards, a reach wider than a shard) the port's one path carries on:
    equal to its unsharded apply, bit for bit."""
    cpus, axis, dtype = CPUS, AXIS, torch.float32
    a = lap2d(37, 27, 1.0, 1.0)                 # n = 999, reach 37
    if case == 'wide reach':
        a = lap2d(64, 5, 1.0, 1.0)              # n = 320, reach 64 > 40
    elif case == 'empty shards':
        a = lap1d(9, 1.0)                       # shards of 2, 2, 2, 2, 1, 0..
    mesh = make_mesh(8, cpus)
    if case == 'one shard':
        mesh = make_mesh(1, cpus)
    elif case == '2 x 4 mesh':
        mesh, axis = make_mesh2d(2, 4, cpus), (HOST_AXIS, AXIS)
    elif case == 'bf16':
        dtype = torch.bfloat16
    whole = DiaMatrix(a, device='cpu')
    if case == 'from_arrays':
        # values outside the matrix, which the unsharded apply never reads
        jd = jax_spmm.DiaMatrix(a)
        val = np.array(jd.val)
        for k, off in enumerate(jd.offsets):
            val[k, :max(0, -off)] = 7.0
            val[k, val.shape[1] - max(0, off):] = 7.0
        whole = DiaMatrix.from_arrays(jd.offsets, val, device='cpu')
    dm = shard_operator(DiaMatrix.from_arrays(
        whole.offsets, whole.val.numpy(), device='cpu'), mesh, axis=axis)
    n = a.shape[0]
    x = torch.from_numpy(np.random.RandomState(2).randn(5, n)
                         .astype(np.float32)).to(dtype)
    want = whole.matmat_rows(x)
    sh = blockvec_sharding(mesh)
    before = dict(sw.LAUNCHES), dict(st.LAUNCHES)
    got = dm.matmat_rows(ShardedRows.split(x, sh))
    assert (dict(sw.LAUNCHES), dict(st.LAUNCHES)) == before
    assert got.sharding is sh and got.dtype == dtype
    assert torch.equal(got.gather(), want)
    if dtype == torch.float32:
        assert _rel(want.numpy(), (a @ x.numpy().T).T) < 1e-6
    # the mesh apply's plain version over the piece table and the per-shard
    # route over copied extended operands give the same floats
    xs = ShardedRows.split(x, dm.val.sharding)
    plan = dm._mesh_plan(dm.val.sharding)
    parts = sw.dia_matmat_rows_mesh_plain(dm.val.parts, xs.parts, plan)
    assert torch.equal(torch.cat(parts, dim=1), want)
    assert torch.equal(torch.cat(_per_shard_route(dm, xs), dim=1), want)
    # and agree with the JAX package's apply of the same matrix (its
    # explicit sharded path takes none of these partitions)
    jd = jax_spmm.DiaMatrix(a)
    ref = np.asarray(jax_spmm._dia_matmat_rows(
        jd.val, jnp.asarray(x.float().numpy()), jd.offsets))
    assert _rel(torch.cat(parts, dim=1).float().numpy(), ref) <= (
        1e-6 if dtype == torch.float32 else 2.0 ** -8)
    if case == '2 x 4 mesh':
        # values split over one axis only: the block is re-split to match
        half = shard_operator(DiaMatrix(a, device='cpu'), mesh, axis=AXIS)
        assert len(half.val.parts) == 4
        got = half.matmat_rows(ShardedRows.split(x, sh))
        assert got.sharding is sh and torch.equal(got.gather(), want)
        with pytest.raises(ValueError, match='axes'):
            shard_operator(DiaMatrix(a, device='cpu'), mesh)
    # JAX's explicit path gives up on a wide reach (and ``device_put``
    # refuses to split 999 lanes over 8 devices at all)
    if case == 'wide reach':
        jmesh = jax_mesh.make_mesh(8)
        jdm = jax_shard(jax_spmm.DiaMatrix(a), jmesh, axis=jax_mesh.AXIS)
        assert jdm.sharded_rows_fn(5, n) is None


def _per_shard_route(dm, xs):
    """The sharded apply shard by shard over extended operands assembled by
    ``ring_extended``, each through the one-piece apply's plain version."""
    lo = max(0, -min(dm.offsets))
    exts, _ = ring_extended(xs, lo, max(0, max(dm.offsets)))
    return [torch.empty_like(own) if ext is None else
            sw.dia_matmat_rows_ext_plain(v, ext, dm.offsets, lo, v.shape[1])
            for v, ext, own in zip(dm.val.parts, exts, xs.parts)]


@pytest.mark.parametrize('case,widths,offsets,devices,launches', [
    ('one device', [512] * 8, (-64, -1, 0, 1, 64), CPUS, 1),
    ('more shards than a table', [10] * 20, (-1, 0, 1), ['cpu'] * 20, 2),
    ('two devices', [64] * 8, (-3, 0, 5), ['cpu'] * 4 + ['meta'] * 4, 2),
    ('wide reach', [40] * 8, (-64, -5, 0, 5, 64), CPUS, 1),
    ('empty shards', [2, 2, 2, 2, 1, 0, 0, 0], (-1, 0, 1), CPUS, 1),
])
def test_mesh_plan_covers_the_ring(case, widths, offsets, devices,
                                   launches):
    """The piece table: every shard's relative lanes [-lo, n_s + hi) are
    covered by its pieces in order, each relative lane read from the global
    lane (start_s + p) mod n; shards are grouped by device, a device's
    shards split over launches only past the table's limits, and lanes on
    another device are staged."""
    plan = sw.DiaMeshPlan(widths, devices, offsets)
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    assert (plan.lo, plan.hi) == (lo, hi)
    assert len(plan.launches) == launches
    starts = np.cumsum([0] + widths[:-1])
    n = sum(widths)
    grouped = []
    for launch in plan.launches:
        assert {plan.devices[s] for s in launch.shards} == {launch.device}
        assert len(launch.shards) <= sw.MESH_MAX_SHARDS
        assert len(launch.sources) <= sw.MESH_MAX_SOURCES
        # source i is the operand part of the launch's shard i
        assert launch.sources[:len(launch.shards)] == [
            ('part', s) for s in launch.shards]
        grouped += launch.shards
        for key in launch.sources:
            assert (key[0] == 'part') == (plan.devices[key[1]]
                                           == launch.device)
    assert grouped == [s for s, w in enumerate(widths) if w]
    for s, w in enumerate(widths):
        if w == 0:
            assert plan.pieces[s] is None
            continue
        pos = -lo
        for start, length, j, lane in plan.pieces[s]:
            assert start == pos and length > 0
            p = np.arange(start, start + length)
            want = (starts[s] + p) % n
            assert np.array_equal(starts[j] + lane + p - start, want)
            pos += length
        assert pos == w + hi
    if case == 'two devices':
        stages = [k for lch in plan.launches for k in lch.sources
                  if k[0] == 'stage']
        assert len(stages) == 4        # each group's two outer halos
    if case == 'wide reach':
        assert min(len(p) for p in plan.pieces) == 5


def test_mesh_plan_checks_run_on_the_cpu():
    with pytest.raises(ValueError, match='pieces'):
        sw.DiaMeshPlan([1] * 200, ['cpu'] * 200, (-150, 0, 150))
    plan = sw.DiaMeshPlan([4, 4], ['cpu'] * 2, (-1, 0, 1))
    vals = [torch.zeros((3, 4))] * 2
    with pytest.raises(ValueError, match='operand parts'):
        sw.dia_matmat_rows_mesh(vals, [torch.zeros((2, 4)),
                                       torch.zeros((2, 5))], plan)
    with pytest.raises(ValueError, match='value part'):
        sw.dia_matmat_rows_mesh([torch.zeros((2, 4))] * 2,
                                [torch.zeros((2, 4))] * 2, plan)
    with pytest.raises(ValueError, match='3 operand parts'):
        sw.dia_matmat_rows_mesh(vals, [torch.zeros((2, 4))] * 3, plan)
    y = sw.dia_matmat_rows_mesh(vals, [torch.ones((2, 4))] * 2, plan)
    assert [tuple(p.shape) for p in y] == [(2, 4)] * 2
    assert sw.LAUNCHES['mesh_float32'] == sw.LAUNCHES['mesh_bfloat16'] == 0


def test_shard_operator_on_ell_and_bsr(mesh):
    """ELL: rows split, applied against the gathered operand, within 1e-6
    of SciPy and of the JAX package's sharded matrix; a BsrMatrix and an
    unknown object are returned unchanged, as the JAX package returns
    its BsrMatrix."""
    n = 400
    a = scs.random(n, n, density=0.02, random_state=3, format='csr')
    a = scs.csr_matrix(a + a.T + scs.eye(n))
    x = np.random.default_rng(7).standard_normal((4, n)).astype(np.float32)
    ref = (a @ x.T).T
    em = shard_operator(EllMatrix(a, device='cpu'), mesh)
    assert em._multi_device() and [p.shape[0] for p in em.val.parts] \
        == [50] * 8
    sh = blockvec_sharding(mesh)
    y = em.matmat_rows(ShardedRows.split(torch.from_numpy(x), sh))
    assert isinstance(y, ShardedRows)
    jmesh = jax_mesh.make_mesh(8)
    jem = jax_shard(jax_spmm.EllMatrix(a), jmesh, axis=jax_mesh.AXIS)
    want = np.asarray(jem.matmat_t(jnp.asarray(x.T))).T
    assert _rel(y.gather().numpy(), ref) < 1e-6
    assert _rel(y.gather().numpy(), want) < 1e-6
    assert _rel(em.matmat_rows(torch.from_numpy(x)).numpy(), ref) < 1e-6
    assert _rel(em.matmat_t(torch.from_numpy(x.T.copy())).numpy(),
                ref.T) < 1e-6
    # a BsrMatrix and any object with neither DIA values nor ELL indices
    # come back unchanged, as from the JAX package's shard_operator
    bm = BsrMatrix(a, bs=16, device='cpu')
    blocks = bm.blocks
    assert shard_operator(bm, mesh) is bm and bm.blocks is blocks
    other = object()
    assert shard_operator(other, mesh) is other
    jbm = jax_spmm.BsrMatrix(a, bs=16)
    jblocks = jbm.blocks
    assert jax_shard(jbm, jmesh, axis=jax_mesh.AXIS) is jbm
    assert jbm.blocks is jblocks


# ---- the sharded LOBPCG -------------------------------------------------

def _both_packages(a, k, degree, bounds, tol, mesh, x0, maxit):
    """(port sharded, port unsharded, JAX sharded) results of one
    preconditioned f64 solve from ``x0``."""
    n = a.shape[0]
    lo, hi = bounds
    out = []
    for sharded in (True, False):
        dm = device_sparse(a, dtype=np.float64, device='cpu')
        kw = {}
        if sharded:
            dm = shard_operator(dm, mesh)
            kw['sharding'] = blockvec_sharding(mesh)
        ch = Chebyshev(a, lo, hi, degree=degree, device_matrix=dm)
        out.append(lobpcg(dm, k, precond=ch._device_fused_rows(), tol=tol,
                          maxit=maxit, dtype=np.float64, x0=x0, **kw))
    jmesh = jax_mesh.make_mesh(8)
    jdm = jax_shard(jax_spmm.device_sparse(a, dtype=np.float64), jmesh,
                    axis=jax_mesh.AXIS)
    jch = JaxChebyshev(a, lo, hi, degree=degree, device_matrix=jdm)
    out.append(jax_lobpcg(
        jdm, k, precond=jch._device_fused_rows(), tol=tol, maxit=maxit,
        dtype=np.float64, x0=x0,
        sharding=NamedSharding(jmesh, P(jax_mesh.AXIS, None))))
    return out


@pytest.mark.parametrize('case', ['lap1d', 'lap3d'])
def test_sharded_lobpcg_matches_jax(mesh, f64_default, case):
    """tests/test_sharded.py:260-285 (lap1d n = 8 x 256, degree 16, 1e-9)
    and :167-192 (lap3d 12^3, degree 10, 1e-8): both packages sharded over
    8 and the port unsharded, from one start block."""
    if case == 'lap1d':
        n = 8 * 256
        a = lap1d(n, 1.0)
        exact = 4.0 * (n + 1) ** 2 * \
            np.sin(np.arange(1, 6) * np.pi / (2 * (n + 1))) ** 2
        bounds, degree, tol, maxit = spectral_bounds(a), 16, 1e-9, 400
    else:
        a = lap3d(12, 12, 12, 1.0, 1.0, 1.0)
        n = a.shape[0]
        exact = np.sort(lap3d_eigenvalues(12, 12, 12, 1.0, 1.0, 1.0))[:5]
        hi = spectral_bounds(a)[1]
        bounds, degree, tol, maxit = (hi * 1e-4, hi), 10, 1e-8, 300
    x0 = np.random.RandomState(0).standard_normal((n, 16))
    sharded, whole, ref = _both_packages(a, 5, degree, bounds, tol, mesh,
                                         x0, maxit)
    for lam, x, r, it, st_ in (sharded, whole, ref):
        assert st_ == 0 and x.shape == (n, 5)
        assert np.abs(lam - exact).max() / exact[-1] < 1e-6
    assert sharded[3] == whole[3] == ref[3]         # iteration counts
    assert _rel(sharded[0], ref[0]) < 1e-8
    assert _rel(sharded[0], whole[0]) < 1e-8
    x = sharded[1]
    assert np.abs(x.T @ x - np.eye(5)).max() < 1e-8


def test_sharded_lobpcg_on_device_sparse_operators(mesh, f64_default):
    """``shard_operator(device_sparse(a), mesh)`` under the sharded solve as
    tests/test_device_solver.py:213-232 calls it (f64, 6 pairs, 1e-6), on a
    2-D mesh too; a DIA operator left whole is split on entry, any other
    operator is applied to the gathered block; a generalized pencil with
    constraints runs sharded."""
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    n = a.shape[0]
    exact = np.sort(lap3d_eigenvalues(10, 10, 10, 1.0, 1.0, 1.0))
    x0 = np.random.RandomState(0).standard_normal((n, 16))
    kw = dict(tol=1e-8, maxit=300, dtype=np.float64, x0=x0)
    whole = device_sparse(a, dtype=np.float64, device='cpu')
    want = lobpcg(whole, 6, **kw)
    runs = {}
    dm = shard_operator(device_sparse(a, dtype=np.float64, device='cpu'),
                        mesh, axis='chips')
    runs['sharded'] = lobpcg(dm, 6, sharding=blockvec_sharding(mesh), **kw)
    mesh2 = make_mesh2d(2, 4, CPUS)
    dm2 = shard_operator(device_sparse(a, dtype=np.float64, device='cpu'),
                         mesh2, axis=(HOST_AXIS, AXIS))
    runs['2-D'] = lobpcg(dm2, 6, sharding=blockvec_sharding(mesh2), **kw)
    runs['split on entry'] = lobpcg(whole, 6,
                                    sharding=blockvec_sharding(mesh), **kw)
    assert not whole._multi_device()            # the caller's matrix stays
    runs['callable'] = lobpcg(whole.matmat_t, 6, n=n,
                              sharding=blockvec_sharding(mesh), **kw)
    ell = shard_operator(EllMatrix(a, dtype=np.float64, device='cpu'), mesh)
    runs['ELL'] = lobpcg(ell, 6, sharding=blockvec_sharding(mesh), **kw)
    for name, (lam, x, r, it, st_) in runs.items():
        assert st_ == 0, name
        assert np.abs(lam - exact[:6]).max() < 1e-6, name
        assert it == want[3], name
        assert _rel(lam, want[0]) < 1e-10, name
    with pytest.raises(TypeError, match='blockvec_sharding'):
        lobpcg(whole, 6, sharding=object())
    # generalized, with constraints
    b = scs.diags(1.0 + np.random.RandomState(2).rand(n), format='csr')
    tb = device_sparse(b, dtype=np.float64, device='cpu')
    _, xc, _, _, st_ = lobpcg(whole, 4, opB=tb, **kw)
    assert st_ == 0
    kw['constraints'] = xc
    lam, x, _, it, st_ = lobpcg(whole, 3, opB=tb, **kw)
    lam_s, x_s, _, it_s, st_s = lobpcg(
        dm, 3, opB=shard_operator(device_sparse(b, dtype=np.float64,
                                                device='cpu'), mesh),
        sharding=blockvec_sharding(mesh), **kw)
    assert st_ == st_s == 0 and it == it_s
    assert _rel(lam_s, lam) < 1e-10
    assert np.abs(xc.T @ (b @ x_s)).max() < 1e-8


@pytest.fixture(scope='module')
def bsr_girder(mesh):
    """A small FE girder (fe_pencil(5, 2, 0.1, seed=2), n = 648) as
    ``BsrMatrix(bs=16)`` in f64, solved by the port's ``lobpcg`` for 4
    pairs with a Chebyshev preconditioner over the same matrix, from one
    start block: the matrices, the solve's arguments and the unsharded and
    the sharded result.  ``shard_operator`` passes the matrix through, so
    under ``sharding=`` the operator and the recurrence apply to the
    gathered block."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        k, mass = fe.fe_pencil(5, 2, 0.1, seed=2)
        n = k.shape[0]
        hi = spectral_bounds(k)[1]
        x0 = np.random.RandomState(8).standard_normal((n, 8))
        kw = dict(tol=1e-8, maxit=200, x0=x0, dtype=np.float64,
                  block_size=8)
        runs = []
        for sharded in (False, True):
            tk = BsrMatrix(k, dtype=np.float64, bs=16, device='cpu')
            tm = BsrMatrix(mass, dtype=np.float64, bs=16, device='cpu')
            extra = {}
            if sharded:
                assert shard_operator(tk, mesh) is tk
                extra['sharding'] = blockvec_sharding(mesh)
            pre = Chebyshev(k, hi * 1e-4, hi, degree=16, device_matrix=tk) \
                .device_rows_operands(8, n, dtype=torch.float64)
            runs.append(lobpcg(tk, 4, opB=tm, precond=pre, **kw, **extra))
    finally:
        torch.set_default_dtype(old)
    return k, mass, hi, kw, runs


def test_sharded_lobpcg_on_bsr_matches_unsharded(bsr_girder):
    """The girder's sharded solve takes the unsharded one's iterations and
    eigenvalues to 1e-10 relative, with B-orthonormal vectors."""
    _, mass, _, _, runs = bsr_girder
    (lam, _, _, it, st0), (lam_s, x_s, _, it_s, st1) = runs
    assert st0 == st1 == 0 and it == it_s
    assert _rel(lam_s, lam) < 1e-10
    assert np.abs(x_s.T @ (mass @ x_s) - np.eye(4)).max() < 1e-8


def test_sharded_lobpcg_on_bsr_matches_jax(bsr_girder):
    """The girder's sharded solve against the JAX package's: the same
    ``BsrMatrix(bs=16)`` passed through its ``shard_operator``, its
    Chebyshev operand form and ``lobpcg`` under its blockvec sharding on
    conftest's 8 virtual devices, from the same start block.  Equal
    iterations, eigenvalues to 1e-10 relative."""
    k, mass, hi, kw, runs = bsr_girder
    n = k.shape[0]
    jmesh = jax_mesh.make_mesh(8)
    jk = jax_spmm.BsrMatrix(k, dtype=np.float64, bs=16)
    jm = jax_spmm.BsrMatrix(mass, dtype=np.float64, bs=16)
    assert jax_shard(jk, jmesh, axis=jax_mesh.AXIS) is jk
    jpre = JaxChebyshev(k, hi * 1e-4, hi, degree=16, device_matrix=jk) \
        .device_rows_operands(8, n, dtype=jnp.float64)
    lam_j, _, _, it_j, st_j = jax_lobpcg(
        jk, 4, opB=jm, precond=jpre,
        sharding=NamedSharding(jmesh, P(jax_mesh.AXIS, None)), **kw)
    lam_s, _, _, it_s, st_s = runs[1]
    assert st_j == st_s == 0 and it_j == it_s
    assert _rel(lam_s, lam_j) < 1e-10


def test_sharded_chebyshev_streams_bf16(mesh):
    """The recurrence over ``ShardedRows`` with f32 and with bf16 iterates
    against the unsharded recurrence: equal bit for bit (every elementwise
    step and every apply is)."""
    a = lap3d(8, 8, 16, 1.0, 1.0, 1.0)
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    whole = DiaMatrix(a, device='cpu')
    dm = shard_operator(DiaMatrix(a, device='cpu'), mesh)
    x = torch.from_numpy(np.random.RandomState(5).randn(8, n)
                         .astype(np.float32))
    xs = ShardedRows.split(x, blockvec_sharding(mesh))
    for bf16 in (False, True):
        fn, ops = Chebyshev(a, lo, hi, degree=6, device_matrix=dm) \
            .device_rows_operands(8, n, stream_bf16=bf16)
        fn0, ops0 = Chebyshev(a, lo, hi, degree=6, device_matrix=whole) \
            .device_rows_operands(8, n, stream_bf16=bf16)
        y = fn(ops, xs)
        assert isinstance(y, ShardedRows) and y.dtype == torch.float32
        assert torch.equal(y.gather(), fn0(ops0, x))


def test_unsharded_lobpcg_issues_the_calls_it_always_did(f64_default):
    """The guard of "unsharded unchanged": one preconditioned f64 solve on
    plain tensors under the profiler.  The counts of torch operations and
    the eigenvalues are those of the solver before it learnt of sharded
    blocks (read there with this very script): the helpers that dispatch
    on the block's type add no call on the plain-tensor path."""
    from torch.profiler import ProfilerActivity, profile
    a = lap3d(10, 10, 10, 1.0, 1.0, 1.0)
    n = a.shape[0]
    lo, hi = spectral_bounds(a)
    x0 = np.random.RandomState(0).standard_normal((n, 8))
    dm = device_sparse(a, dtype=np.float64, device='cpu')
    calls = []
    apply_rows = dm.matmat_rows
    dm.matmat_rows = lambda x: calls.append(1) or apply_rows(x)
    pre = Chebyshev(a, lo, hi, degree=10, device_matrix=dm) \
        .device_rows_operands(8, n, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lam, x, r, it, st_ = lobpcg(dm, 6, precond=pre, tol=1e-8, maxit=300,
                                    x0=x0, dtype=np.float64)
    assert (st_, it, len(calls)) == (0, 32, 67)
    ops = {e.key: e.count for e in prof.key_averages()}
    assert {k: ops.get('aten::' + k) for k in (
        'matmul', 'mul', 'sub', 'add', 'add_', 'div', 'where', 'cat',
        'linalg_eigh', 'sum', 'linalg_vector_norm', 'zeros_like', 'sqrt',
        'clamp', 'index')} == {
        'matmul': 1034, 'mul': 4165, 'sub': 743, 'add': 769, 'add_': 2709,
        'div': 226, 'where': 1100, 'cat': 97, 'linalg_eigh': 97, 'sum': 229,
        'linalg_vector_norm': 3, 'zeros_like': 2, 'sqrt': 259, 'clamp': 453,
        'index': 10}
    before = np.array([29.408101155874895, 58.02204582543761,
                       58.02204582543763, 58.02204582543764,
                       86.63599049500004, 86.63599049500041])
    assert np.abs(lam - before).max() <= 1e-13 * before.max()


# ---- ShardedEllMatrix ---------------------------------------------------

def _scattered():
    a = scs.random(400, 400, density=0.02, random_state=3, format='csr')
    return scs.csr_matrix(a + a.T + scs.eye(400))


@pytest.mark.parametrize('case,mode,m', [('one hop', 'halo', 8),
                                         ('multi hop', 'halo', 4),
                                         ('gather', 'gather', 4)])
def test_sharded_ell_matches_jax(mesh, case, mode, m):
    """The three cases of tests/test_sharded.py:71-136: lap3d 12^3 (one-hop
    halos), lap3d 5^3 (n = 125, chunk 16, the band spans several chunks)
    and a scattered pattern (gathered): the same object as JAX's, products
    within 1e-5 of SciPy and 1e-6 of JAX's."""
    a = {'one hop': lambda: lap3d(12, 12, 12, 1.0, 1.0, 1.0),
         'multi hop': lambda: lap3d(5, 5, 5, 1.0, 1.0, 1.0),
         'gather': _scattered}[case]()
    n = a.shape[0]
    x = np.random.default_rng(5).standard_normal((n, m)).astype(np.float32)
    jsm = JaxSharded(a, jax_mesh.make_mesh(8))
    sm = ShardedEllMatrix(a, mesh)
    assert sm.mode == jsm.mode == mode
    assert sm.halo == tuple(jsm.halo) and sm.chunk == jsm.chunk
    assert (sm.n_padded, sm.row_degree, sm.nnz, sm.shape) == (
        jsm.n_padded, jsm.row_degree, jsm.nnz, jsm.shape)
    assert np.array_equal(sm.perm, jsm.perm)
    assert np.array_equal(sm.iperm, jsm.iperm)
    assert np.array_equal(sm.idx.gather().numpy(), np.asarray(jsm.idx))
    assert np.array_equal(sm.val.gather().numpy(), np.asarray(jsm.val))
    if case == 'one hop':
        assert 1 <= max(sm.halo) <= sm.chunk
    elif case == 'multi hop':
        assert max(sm.halo) > sm.chunk
    want = np.asarray(jsm.matmat_t(x))
    ref = a @ x
    for operand in (x, torch.from_numpy(x)):
        got = sm.matmat_t(operand)
        assert isinstance(got, torch.Tensor) and got.shape == (n, m)
        assert _rel(got.numpy(), ref) < 1e-5
        assert _rel(got.numpy(), want) < 1e-6
    # the JAX object's arrays carried over: no second RCM
    twin = ShardedEllMatrix.from_arrays(
        np.asarray(jsm.idx), np.asarray(jsm.val), jsm.perm, jsm.halo,
        jsm.chunk, jsm.mode, mesh, nnz=jsm.nnz)
    assert twin.nnz == sm.nnz and twin.halo == sm.halo
    assert torch.equal(twin.matmat_t(x), sm.matmat_t(x))
    # and the other regime computes the same product
    if mode == 'halo':
        other = ShardedEllMatrix(a, mesh, mode='gather')
        assert other.halo == (0, 0)
        assert _rel(other.matmat_t(x).numpy(), ref) < 1e-5
    else:
        with pytest.raises(ValueError, match='whole ring'):
            ShardedEllMatrix(a, mesh, mode='halo')
        with pytest.raises(ValueError, match='whole ring'):
            JaxSharded(a, jax_mesh.make_mesh(8), mode='halo')


def test_sharded_ell_checks():
    a = lap3d(5, 5, 5, 1.0, 1.0, 1.0)
    sm = ShardedEllMatrix(a, make_mesh(3, CPUS))
    x = np.random.default_rng(1).standard_normal((125, 2)).astype(np.float32)
    assert sm.chunk == 42 and sm.n_padded == 126
    assert _rel(sm.matmat_t(x).numpy(), a @ x) < 1e-5
    with pytest.raises(ValueError, match='mode'):
        ShardedEllMatrix.from_arrays(
            sm.idx.gather().numpy(), sm.val.gather().numpy(), sm.perm,
            sm.halo, sm.chunk, 'auto', sm.mesh)
    with pytest.raises(ValueError, match='shards of'):
        ShardedEllMatrix.from_arrays(
            sm.idx.gather().numpy(), sm.val.gather().numpy(), sm.perm,
            sm.halo, sm.chunk, 'halo', make_mesh(2, CPUS))


# ---- the entry points ---------------------------------------------------

@pytest.mark.parametrize('n_devices', [8, 3, 1])
def test_graft_dryrun_multichip(n_devices):
    graft_entry.dryrun_multichip(n_devices, device='cpu')


def test_graft_entry_matches_jax():
    import __graft_entry__ as g
    fn, args = graft_entry.entry(device='cpu')
    y, gram = fn(*args)
    jfn, jargs = g.entry()
    jy, jgram = jax.jit(jfn)(*jargs)
    assert y.shape == (32, 1024) and gram.shape == (32, 32)
    for got, want, arg in ((y, jy, args[0]), (gram, jgram, args[1])):
        assert _rel(got.numpy(), np.asarray(want)) < 1e-5
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))


def test_sharded_spmm_bench_runs_on_the_cpu_when_asked(capsys):
    out = bench_spmm_sharded.main(['8', '4', '--device', 'cpu', '--reps',
                                   '1'])
    text = capsys.readouterr().out
    assert out['n'] == 512 and out['m'] == 4 and out['shards'] == 8
    assert out['mode'] == 'halo' and out['err'] < 1e-5
    assert out['ms'] > 0 and out['ms_single'] > 0
    # both halos counted, not the tuple repeated
    assert out['halo_gb'] == sum(out['halo']) * 4 * 4 * 8 / 1e9
    assert 0 < out['halo_gb'] < out['local_gb']
    assert 'rel err vs scipy' in text and 'the CPU' in text
    assert 'no scaling measurement' in text


def test_copy_sweep_has_an_hbm2hbm_line(capsys):
    small = ['--device', 'cpu', '--m', '8', '--n', '1000', '--reps', '1']
    rows = bench_grid_shapes.main(['hbm2hbm', '--tiles', '8', '64'] + small)
    out = capsys.readouterr().out
    assert [(r['variant'], r['tile'], r['n']) for r in rows] == [
        ('hbm2hbm', 8, 1000), ('hbm2hbm', 64, 960)]
    assert out.count('hbm2hbm tile') == 2 and out.count('GB/s') == 2
    assert 'hbm2hbm' in bench_grid_shapes.VARIANTS
    assert bench_grid_shapes.COPY_TILES == (bench_grid_shapes.TILE,)
