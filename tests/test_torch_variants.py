"""The kernel-structure A/B entry points of the PyTorch port against the
JAX package, on the CPU: the sliding-window and tile-ring DIA applies, the
tiled and pipelined stream copies, the two sweeps as a whole, and the one
timer.

Inputs are seeded NumPy arrays at small sizes (n = 1024, m = 8).  The JAX
side runs its Pallas kernels in interpret mode: the window kernels are
built with ``interpret=True``, the copy kernels run unedited under
``force_tpu_interpret_mode``.  The port's side is each wrapper on CPU
tensors, which runs the wrapper's checks and the kernel's plain version.

Tolerances.  DIA: entrywise, ``2 noff 2^-24 sum_k |val[k, i]| |x[r, i +
off_k]|``, twice the f32 summation error bound of an entry's terms, since
the JAX tile ring sums the diagonals in another order.  Copies: exact
equality, one f32 multiply per element.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from raleigh_tpu.examples.laplace import lap3d as jax_lap3d
from raleigh_tpu.ops import spmm_window as jax_sw
from raleigh_tpu.ops.spmm import DiaMatrix as JaxDiaMatrix
from raleigh_tpu_torch.benches import bench_grid_shapes as grid_shapes
from raleigh_tpu_torch.benches import bench_window_tiles as window_tiles
from raleigh_tpu_torch.benches.timing import time_ms
from raleigh_tpu_torch.ops import _build
from raleigh_tpu_torch.ops import spmm_window as sw
from raleigh_tpu_torch.ops import stream as st

# One torch thread: the suite runs in several worker processes at once, and
# with a thread pool per process they fight over the cores (the small
# operand blocks here gain nothing from more threads).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, TILE = 1024, 8, 256


def _jax_grid_shapes():
    """The JAX package's copy sweep, loaded from its file (``benches/`` at
    the root is a directory of scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(
        'jax_bench_grid_shapes',
        os.path.join(ROOT, 'benches', 'bench_grid_shapes.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stencil(name):
    """(offsets, val (noff, N) f32) of a DIA matrix."""
    rng = np.random.RandomState(11)
    if name == 'lap3d':
        d = JaxDiaMatrix(jax_lap3d(8, 8, 16, 1.0, 1.0, 1.0))
        return tuple(d.offsets), np.array(d.val, dtype=np.float32)
    offsets = {'1-D': (-1, 0, 1),
               'unsymmetric': (-130, -3, 0, 5, 200)}[name]
    val = rng.standard_normal((len(offsets), N)).astype(np.float32)
    for k, off in enumerate(offsets):       # no entry outside the matrix
        val[k, :max(0, -off)] = 0
        val[k, N - max(0, off):] = 0
    return offsets, val


@pytest.mark.parametrize('stencil', ['lap3d', '1-D', 'unsymmetric'])
@pytest.mark.parametrize('variant', ['slide', 'tiles'])
def test_staged_window_apply_matches_jax(variant, stencil):
    offsets, val = _stencil(stencil)
    x = np.random.RandomState(5).standard_normal((M, N)).astype(np.float32)
    build = {'slide': jax_sw.build_dia_window_slide,
             'tiles': jax_sw.build_dia_window_tiles}[variant]
    want = np.asarray(build(offsets, val, N, M, tile=TILE,
                            interpret=True)(x))
    tv, tx = torch.from_numpy(val), torch.from_numpy(x)
    got = sw.VARIANTS[variant](tv, tx, offsets, TILE)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    terms = sw.dia_matmat_rows_plain(tv.abs(), tx.abs(), offsets).numpy()
    bound = 2 * len(offsets) * 2.0 ** -24 * terms
    assert np.all(np.abs(got.numpy() - want) <= bound)
    # and the port's three structures are one function
    ring = sw.VARIANTS['ring'](tv, tx, offsets, TILE)
    assert torch.equal(got, ring)


def test_tile_ring_needs_the_offsets_inside_one_tile():
    """max|offset| > tile raises in both packages."""
    offsets, val = _stencil('unsymmetric')
    x = torch.zeros((M, N))
    with pytest.raises(ValueError, match='<= tile'):
        jax_sw.build_dia_window_tiles(offsets, val, N, M, tile=128,
                                      interpret=True)
    with pytest.raises(ValueError, match='<= tile'):
        sw.dia_matmat_rows_tiles(torch.from_numpy(val), x, offsets, 128)


def test_staged_window_checks_run_on_the_cpu():
    offsets, val = _stencil('lap3d')
    tv, x = torch.from_numpy(val), torch.zeros((M, N))
    with pytest.raises(ValueError, match='shared memory'):
        sw.dia_matmat_rows_slide(tv, x, offsets, 40000)
    with pytest.raises(ValueError, match='shared memory'):
        sw.dia_matmat_rows_tiles(tv, x, offsets, 20000)
    with pytest.raises(ValueError, match='at least 1'):
        sw.dia_matmat_rows_tiles(tv, x, offsets, 0)
    with pytest.raises(TypeError, match='f32'):
        sw.dia_matmat_rows_slide(tv, x.bfloat16(), offsets, TILE)
    with pytest.raises(ValueError, match='shape'):
        sw.dia_matmat_rows_slide(tv, x[:, :-1].contiguous(), offsets, TILE)
    with pytest.raises(ValueError, match='contiguous'):
        sw.dia_matmat_rows_tiles(tv, torch.zeros((N, M)).T, offsets, TILE)
    with pytest.raises(ValueError, match='at most'):
        sw.dia_matmat_rows_slide(torch.zeros((200, N)), x,
                                 tuple(range(200)), TILE)


@pytest.mark.parametrize('variant,arg', [('tiled', 1), ('tiled', 4),
                                         ('pipelined', 2), ('pipelined', 4)])
def test_stream_probes_match_jax(variant, arg):
    """``build_blockspec(per_step=1|4)`` and ``build_manual(depth=2|4)`` in
    interpret mode against the port's wrappers: exact equality."""
    jb = _jax_grid_shapes()
    x = np.random.RandomState(9).standard_normal((M, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        if variant == 'tiled':
            want = np.asarray(jb.build_blockspec(M, N, 128, per_step=arg)(x))
        else:
            want = np.asarray(jb.build_manual(M, N, 128, arg)(x))
    tx = torch.from_numpy(x)
    if variant == 'tiled':
        got = st.stream_scale_tiled(tx, st.REFERENCE_SCALE, 128, arg)
    else:
        got = st.stream_scale_pipelined(tx, st.REFERENCE_SCALE, 128, arg)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, x * np.float32(0.99999))


def test_stream_probe_checks_run_on_the_cpu():
    x = torch.zeros((5, 1000))
    with pytest.raises(ValueError, match='multiple of tile'):
        st.stream_scale_tiled(x, 2.0, 16)
    with pytest.raises(ValueError, match='multiple of tile'):
        st.stream_scale_tiled(x, 2.0, 8, per_step=4)
    with pytest.raises(ValueError, match='multiple of 4'):
        st.stream_scale_tiled(x, 2.0, 10)
    with pytest.raises(ValueError, match='per_step'):
        st.stream_scale_tiled(x, 2.0, 8, per_step=0)
    with pytest.raises(ValueError, match='depth'):
        st.stream_scale_pipelined(x, 2.0, 8, 3)
    with pytest.raises(ValueError, match='shared memory'):
        st.stream_scale_pipelined(torch.zeros((1, 1 << 17)), 2.0, 1 << 16, 4)
    # the stages' barriers count: depth * tile * 4 bytes alone would fit
    # these tiles, the stages and their barriers do not; 4 elements less do
    for depth, edge in ((2, 29052), (4, 14524)):
        assert depth * (edge + 4) * 4 <= _build.SMEM_PER_BLOCK
        with pytest.raises(ValueError, match='shared memory'):
            st.stream_scale_pipelined(torch.zeros((1, 2 * (edge + 4))), 2.0,
                                      edge + 4, depth)
        xe = torch.ones((1, 2 * edge))
        assert torch.equal(st.stream_scale_pipelined(xe, 2.0, edge, depth),
                           2 * xe)
    with pytest.raises(ValueError, match='contiguous'):
        st.stream_scale_pipelined(x[:, :500], 2.0, 4, 2)
    with pytest.raises(TypeError, match='f32'):
        st.stream_scale_tiled(x.double(), 2.0, 8)


def test_clustered_window_plan_on_the_cpu():
    """Rows per block and val chunk lanes of the clustered kernels at the
    tile sweep's shape (reach 20,000 lanes, 7 diagonals): on the bulk-copy
    branch, two rows a block only where a chunk of at least 800 lanes still
    fits beside them, else one row with the widest chunk that fits, up to
    2,048 lanes; where no chunk of 800 lanes fits (the sliding window's
    16,384, the tile ring's 12,288 and 14,336), no stage (chunk 0, val from
    device memory) and the most rows whose windows fit; the per-thread
    branch keeps
    no stage and sizes its rows by the windows alone.  The shared-memory
    edge raises."""
    def plan(variant, tile, m=32, noff=7, bulk=True):
        lanes = 4 * tile if variant == 'tiles' else 20000 + 2 * tile
        return sw._window_plan(m, lanes, noff, bulk, variant)

    assert plan('slide', 2048) == (1, 2048)
    assert plan('slide', 4096) == (1, 2048)
    assert plan('slide', 8192) == (1, 1544)
    assert plan('slide', 16384) == (1, 0)
    assert plan('tiles', 10240) == (1, 1220)
    assert plan('tiles', 12288) == (1, 0)
    assert plan('tiles', 14336) == (1, 0)
    assert plan('slide', 2048, m=1) == (1, 2048)
    assert sw._window_plan(5, 1000, 7, True, 'slide') == (8, 2048)
    # without room for a stage of 800 lanes beside a row, no stage
    assert plan('tiles', 11696) == (1, 804)
    assert plan('tiles', 11712) == (1, 800)
    assert plan('tiles', 11716) == (1, 0)
    # 128 diagonals: no stage of 800 lanes fits beside 8 rows' windows
    assert sw._window_plan(16, 1152, 128, True, 'slide') == (8, 0)
    # where no stage fits, two rows share the val they read
    assert plan('slide', 4096, bulk=True, noff=40) == (2, 0)
    # the per-thread branch keeps no stage: two rows at tile 4,096
    assert plan('slide', 4096, bulk=False) == (2, 0)
    assert plan('tiles', 10240, bulk=False) == (1, 0)
    # 14,512 lanes a tile and the barriers fill a block; 14,513 do not
    assert plan('tiles', 14512) == (1, 0)
    for bulk in (True, False):
        with pytest.raises(ValueError, match='shared memory'):
            plan('tiles', 14513, bulk=bulk)
    # the slide kernel rounds the reach to 4 lanes a side
    assert sw._reach((-10000, -1, 0, 1, 10000)) == 20000
    assert sw._reach((-3, 0, 5)) == 12


def test_window_sweep_runs_on_the_cpu_when_asked(capsys):
    small = ['--device', 'cpu', '--m', '8', '--grid', '8', '8', '16',
             '--reps', '1']
    for variant, tiles in (('ring', []), ('slide', ['128', '256']),
                           ('tiles', ['64', '256'])):
        rows = window_tiles.main([variant] + tiles + small)
        out = capsys.readouterr().out
        assert len(rows) == max(1, len(tiles)) + 1
        assert out.count('us/apply') == len(rows)
        assert out.count('%-5s ' % variant) == max(1, len(tiles))
        assert 'torch.sparse.mm' in out and 'the CPU' in out
        assert all(np.isfinite(r['ms']) and r['ms'] > 0 for r in rows)
    # a tile the kernel cannot take raises: nothing is swapped in
    with pytest.raises(ValueError, match='<= tile'):
        window_tiles.main(['tiles', '32'] + small)
    # with no device named the sweep runs on the card, or raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            window_tiles.main(['slide', '128', '--grid', '8', '8', '16'])


def test_copy_sweep_runs_on_the_cpu_when_asked(capsys):
    small = ['--device', 'cpu', '--m', '8', '--n', '1000', '--tiles', '8',
             '64', '--reps', '1']
    rows = grid_shapes.main(small)
    out = capsys.readouterr().out
    assert [(r['variant'], r['tile']) for r in rows] == [
        ('blockspec', 8), ('blockspec', 64), ('blockspec4', 8),
        ('blockspec4', 64), ('manual2', 8), ('manual2', 64), ('manual4', 8),
        ('manual4', 64), ('spans', None), ('torch', None),
        ('hbm2hbm', 8), ('hbm2hbm', 64)]
    assert out.count('GB/s') == len(rows)
    # n is trimmed to whole blocks, as the reference trims it for blockspec4
    assert [r['n'] for r in rows] == [1000, 960, 992, 768, 1000, 960, 1000,
                                      960, 1000, 1000, 1000, 960]
    # the copy with no on-chip bounce runs, alone too
    alone = grid_shapes.main(['hbm2hbm'] + small)
    assert [(r['variant'], r['tile']) for r in alone] == [('hbm2hbm', 8),
                                                          ('hbm2hbm', 64)]
    capsys.readouterr()
    with pytest.raises(ValueError, match='unknown variant'):
        grid_shapes.main(['blockspec8'] + small)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            grid_shapes.main(['torch', '--m', '8', '--n', '1000'])


def test_the_timer_counts_its_calls_and_names_its_device():
    calls = []
    ms = time_ms(lambda: calls.append(1), 5, device='cpu')
    assert len(calls) == 5 + 3 and ms >= 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            time_ms(lambda: None, 1)
        with pytest.raises(ValueError, match='CUDA device'):
            st.stream_rate(device='cpu')
