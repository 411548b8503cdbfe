"""The byte counts of the two kernels' rooflines, and the reading of the
kernels' names as the profiler gives them."""

import pytest

from portbench import harness, registry
from portbench.rooflines import e1, k1, share
from portbench.tasks import partial_hevp
from portbench.tracing import Trace

BW = 3.35e12
FE = {'n': 139179, 'nnz': 7819533, 'noff': None, 'nnz_b': 7819533}
LAP = {'n': 1280000, 'nnz': 8888800, 'noff': 7, 'nnz_b': None}
E1_F32 = ('void (anonymous namespace)::ell_rows_kernel<float, float, float, '
          '4>(int const*, float const*, float const*, float*, '
          '(anonymous namespace)::Walk)')
K1_BF16 = ('void (anonymous namespace)::dia_lanes_kernel<__nv_bfloat16>('
           'float const*, __nv_bfloat16 const*, __nv_bfloat16*, int const*, '
           'long, long, long)')


def test_the_configurations_sizes_are_what_their_makers_make():
    sizes = registry.load('configs', 'shipsec1_fe')['sizes']
    assert (sizes['n'], sizes['nnz_K']) == (FE['n'], FE['nnz'])
    sizes = registry.load('configs', 'lap3d_1p28m')['sizes']
    assert (sizes['n'], sizes['nnz'], sizes['diagonals']) == \
        (LAP['n'], LAP['nnz'], LAP['noff'])
    # the Laplacian's count in closed form: 7 n less the missing neighbours
    nx, ny, nz = 100, 100, 128
    assert 7 * nx * ny * nz - 2 * (ny * nz + nx * nz + nx * ny) == LAP['nnz']


def test_e1_bound_on_the_nonzeros():
    """f32 values, m = 16 on shipsec_like(): 0.0242 ms, not the padded
    layout's 0.0319."""
    nbytes = e1.launch_bytes(E1_F32, FE, 16)
    assert nbytes == 7819533 * 8 + 139180 * 4 + 2 * 139179 * 16 * 4
    assert round(1e3 * nbytes / BW, 4) == 0.0242
    f64 = E1_F32.replace('float, float, float', 'float, double, double')
    assert e1.launch_bytes(f64, FE, 8) == \
        7819533 * 8 + 139180 * 4 + 2 * 139179 * 8 * 8
    assert e1.launch_bytes(E1_F32.replace('::ell', '::prev::ell'), FE,
                           16) is None
    assert e1.launch_bytes(K1_BF16, FE, 16) is None
    assert e1.launch_bytes(E1_F32, dict(FE, nnz_b=1), 16) is None


def test_k1_bound_on_the_stored_diagonals():
    """lap3d(100,100,128), m = 16: f32 0.0596 ms, bf16 x and y 0.0352."""
    f32 = K1_BF16.replace('__nv_bfloat16', 'float')
    assert round(1e3 * k1.launch_bytes(f32, LAP, 16) / BW, 4) == 0.0596
    assert round(1e3 * k1.launch_bytes(K1_BF16, LAP, 16) / BW, 4) == 0.0352
    wide = ('void (anonymous namespace)::wide::dia_lanes_kernel<float>('
            'float const*, double const*, double*, int const*, long, long)')
    assert k1.launch_bytes(wide, LAP, 8) == 7 * 1280000 * 4 \
        + 2 * 1280000 * 8 * 8
    assert k1.launch_bytes(wide.replace('<float>', '<double>'), LAP, 8) == \
        7 * 1280000 * 8 + 2 * 1280000 * 8 * 8
    assert k1.launch_bytes(f32.replace('::dia', '::prev::dia'), LAP,
                           16) is None
    assert k1.launch_bytes(E1_F32, LAP, 16) is None
    assert k1.is_launch(wide) and not k1.is_launch(E1_F32)


def test_share_sums_bounds_over_times():
    span = (0.0, 1.0)
    trace = Trace([(E1_F32, 0.1, 0.1 + 4.84e-5), (E1_F32, 0.2, 0.2 + 4.84e-5),
                   ('Memcpy DtoH', 0.3, 0.31), ('other', 0.4, 0.5)], [],
                  [span])
    got = share(trace, FE, 16, e1.launch_bytes, {'hbm_bytes_per_s': BW})
    assert got == pytest.approx(100 * 0.0241576 / 0.0484, rel=1e-4)
    assert share(trace, FE, 16, k1.launch_bytes,
                 {'hbm_bytes_per_s': BW}) is None
    assert share(trace, FE, 16, e1.launch_bytes, None) is None


def test_problem_stats_count_the_inputs():
    cell = harness.Cell('lap3d_1p28m.lobpcg4', params={'grid': [6, 7, 8]})
    p = cell.make(5)
    assert partial_hevp.stats(p) == {
        'n': 336, 'nnz': 7 * 336 - 2 * (56 + 48 + 42), 'nnz_b': None}
    assert k1.populated_diagonals(p['A']) == 7
    cell = harness.Cell('shipsec1_fe.lobpcg6', params={'nc': 6})
    p = cell.make(5)
    stats = partial_hevp.stats(p)
    assert stats['nnz'] == stats['nnz_b'] == p['A'].nnz


def test_trace_idle_and_breakdown():
    trace = Trace([('k1', 1.0, 1.2), ('k2', 1.1, 1.3), ('k1', 1.6, 1.75)],
                  [('aten::linalg_eigh', 1.35, 1.55), ('cudaLaunchKernel',
                                                       1.58, 1.59)],
                  [(1.0, 1.5), (1.5, 2.0)])
    assert trace.solves == 2 and trace.window_s == pytest.approx(1.0)
    assert trace.busy_s == pytest.approx(0.45)
    out = trace.breakdown()
    assert out['device_ops'][0] == ['k1', pytest.approx(0.35)]
    assert out['idle_gaps'] == [
        ['host: aten::linalg_eigh', pytest.approx(0.3)],
        ['host: python', pytest.approx(0.25)]]
