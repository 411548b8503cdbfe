"""The 48-mode cell ``shipsec1_modal48.lobpcg48``: its configuration and
workload as the registry finds them, the least work of the device
LOBPCG's block products (``rooflines/lobpcg_dense.py``) against what the
program's step issues, and the two readers that split the products' and
the ``eigh`` calls' kernels (``dense.flops_pct``, ``ritz.eigh_ms``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, registry
from portbench.rooflines import lobpcg_dense
from portbench.tracing import Trace

CELL = 'shipsec1_modal48.lobpcg48'
FE = {'n': 139179, 'nnz': 7819533, 'nnz_b': 7819533}
GRAM_16 = ('void (anonymous namespace)::gram_gemm_kernel<float, 16, 16, '
           'false>(float const*, float const*, float*, long, long)')
CUBLAS = ('sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_'
          'warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas')
SGEMM = ('void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_tn_align1>('
         'cutlass_80_simt_sgemm_64x64_8x5_tn_align1::Params)')
SYTRD = ('void sytrd4_gpu<sytrd_params<double, 32, 8, 512, 32, 16, 1, 2> >'
         '(int, sytrd_params<double, 32, 8, 512, 32, 16, 1, 2>::data_type*, '
         'int, int)')
SYEVBJ = ('void syevbj_batch_32x16<float, float>(long, int const*, int '
          'const*, int const*, long, float const*, long, float, float*, '
          'int*, float, int)')
SPLITK = ('void cublasLt::splitKreduce_kernel<32, 16, int, float, float, '
          'float, float, false, float, float, float, true, false, false, '
          'false>(cublasLt::cublasSplitKParams<float>, float const*)')
# kernels of an eigh call whose names a product's pattern also matches
F64_GEMM = ('sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize32x32x32_stage3_'
            'warpsize2x2x1_tensor16x8x16_aligna8_alignc8_execute_kernel__5x_'
            'cublas')
SKINNY = ('void gemmcn_skinny_kernel<double, 2, 4>(int, int, int, double '
          'const*, long, long, double const*, long, long, double*, long, '
          'long)')
ELEMENTWISE = ('void at::native::vectorized_elementwise_kernel<4, '
               'at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> '
               '>(int, at::native::CUDAFunctor_add<float>, '
               'std::array<char*, 3ul>)')
PEAKS = {'hbm_bytes_per_s': 3.35e12}


def test_the_cell_and_its_configuration_load_by_name():
    bench = registry.benchmark()
    cell = harness.Cell(CELL)
    wl, config = cell.workload, cell.config
    assert wl['config'] == config['name'] == 'shipsec1_modal48'
    assert (wl['which'], wl['block'], config['modes'], config['block']) == \
        (48, 64, 48, 64)
    fe = registry.load('configs', 'shipsec1_fe')
    assert config['params'] == fe['params'] and config['sizes'] == \
        fe['sizes'] and config['reduced'] == []
    assert set(config['assumed'][:3]) == set(fe['assumed'])
    entry, = [c for c in bench['configs'] if c['name'] == config['name']]
    assert entry['source'] == config['source'] and len(entry['source']) <= 200
    # a deployment of its own: no other configuration has its source and cuts
    own = (entry['source'], entry['reduced'])
    assert all((c['source'], c['reduced']) != own
               for c in bench['configs'] if c['name'] != entry['name'])
    w, = [w for w in bench['workloads'] if w['name'] == CELL]
    assert (w['chips'], w['config'], w['traffic']) == \
        (1, 'shipsec1_modal48', 'lobpcg48')
    per_layer = {m['name']: m for m in
                 registry.metrics_for(bench, CELL, 'per_layer')}
    assert set(per_layer) == {'dense.flops_pct', 'ritz.eigh_ms'}
    assert [m['name'] for m in registry.metrics_for(bench, CELL,
                                                    'end_to_end')] == \
        ['solve_ms', 'setup_s']
    for m in per_layer.values():
        assert m['workloads'] == [CELL] and m['moves'] == 'solve_ms'
        assert m['source'] == 'device_trace'


def test_the_least_work_at_the_cells_shapes():
    """m = 64, n = 139,179, B given: 22,259,732,544 FLOP an iteration,
    0.333 ms at the f32 peak; without B two of each three image products
    go."""
    assert lobpcg_dense.flops(64, 139179) == 22259732544
    assert round(1e3 * lobpcg_dense.flops(64, 139179)
                 / lobpcg_dense.F32_PEAK, 3) == 0.333
    m, n = 64, 139179
    assert lobpcg_dense.flops(m, n, generalized=False) == \
        3 * m * (3 * m + 1) * n + 2 * 2 * 3 * m * m * n + 2 * 2 * 2 * m * m * n


@pytest.mark.parametrize('generalized', [True, False], ids=['km', 'k'])
def test_the_least_work_is_no_more_than_the_step_issues(generalized,
                                                        monkeypatch):
    """The FLOPs of every Gram and every combination the port's ``_Step``
    issues in an iteration (2 ma mb n and 2 p q n, counted by wrapping
    ``_gram`` and ``_mixed``) are at least the roofline's count, on a
    diagonal pencil at m = 64, n = 600 on the CPU."""
    from raleigh_tpu_torch.core import device_solver as ds
    n, m = 600, 64
    rng = np.random.default_rng(3)
    a = torch.as_tensor(np.sort(rng.uniform(1.0, 1e3, n)),
                        dtype=torch.float32)
    b = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32)
    issued, inside = [0], [False]
    gram, mixed, call = ds._gram, ds._mixed, ds._Step.__call__

    def counted_gram(x, y):
        if inside[0]:
            issued[0] += 2 * x.shape[0] * y.shape[0] * x.shape[1]
        return gram(x, y)

    def counted_mixed(c, block, out=None):
        if inside[0]:
            issued[0] += 2 * c.shape[0] * c.shape[1] * block.shape[1]
        return mixed(c, block, out)

    def counted_call(self, state):
        inside[0] = True
        try:
            return call(self, state)
        finally:
            inside[0] = False
    monkeypatch.setattr(ds, '_gram', counted_gram)
    monkeypatch.setattr(ds, '_mixed', counted_mixed)
    monkeypatch.setattr(ds._Step, '__call__', counted_call)
    out = ds.lobpcg(lambda v: v * a[:, None], 48, n=n,
                    opB=(lambda v: v * b[:, None]) if generalized else None,
                    block_size=m, maxit=4, chunk=4, device='cpu')
    its = out[3]
    assert its == 4 and issued[0] > 0
    assert issued[0] >= its * lobpcg_dense.flops(m, n, generalized)


def _record(ops, iterations=(16, 16), peaks=PEAKS, engine='auto'):
    trace = Trace(ops, [], [(0.0, 1.0), (1.0, 2.0)])
    return SimpleNamespace(trace=trace, stats=FE, peaks=peaks,
                           cell={'block': 64, 'engine': engine},
                           iterations=list(iterations))


def _read(name, record):
    return registry.module('metrics', name).read(record)


OPS = [(GRAM_16, 0.10, 0.10 + 1e-4), (CUBLAS, 0.20, 0.20 + 3e-3),
       (SGEMM, 0.30, 0.30 + 2e-3), (SPLITK, 0.35, 0.35 + 1e-5),
       (SYTRD, 0.40, 0.40 + 4e-3), (SYEVBJ, 0.50, 0.50 + 5e-4),
       (F64_GEMM, 0.60, 0.60 + 2e-4), (SKINNY, 0.65, 0.65 + 3e-5),
       (ELEMENTWISE, 0.70, 0.70 + 7e-3)]
PRODUCTS_S = 1e-4 + 3e-3 + 2e-3 + 1e-5
EIGH_S = 4e-3 + 5e-4 + 2e-4 + 3e-5


def test_the_readers_count_each_kernel_once():
    """Products: the Gram kernel, cuBLAS's f32 GEMMs and their split-K
    sums; ``eigh``: cuSOLVER's, with the f64 products it launches, which
    both patterns match and which count there alone; elementwise kernels
    in neither."""
    record = _record(OPS)
    work = 32 * lobpcg_dense.flops(64, 139179)
    assert _read('dense.flops_pct', record) == pytest.approx(
        100 * work / lobpcg_dense.F32_PEAK / PRODUCTS_S, rel=1e-9)
    assert _read('ritz.eigh_ms', record) == pytest.approx(
        1e3 * EIGH_S / 2, rel=1e-9)
    assert lobpcg_dense.seconds(record.trace) == pytest.approx(
        (PRODUCTS_S, EIGH_S), rel=1e-12)


def test_the_readers_read_nothing_where_the_window_holds_none():
    assert _read('dense.flops_pct', _record(OPS[4:])) is None
    assert _read('ritz.eigh_ms', _record(OPS[:4] + OPS[-1:])) is None
    for name in ('dense.flops_pct', 'ritz.eigh_ms'):
        assert _read(name, SimpleNamespace(
            trace=None, stats=FE, peaks=PEAKS, iterations=[16],
            cell={'block': 64, 'engine': 'auto'})) is None
    # off the card (no peaks), without iterations, on the core Solver
    assert _read('dense.flops_pct', _record(OPS, peaks=None)) is None
    assert _read('dense.flops_pct', _record(OPS, iterations=[None])) is None
    assert _read('dense.flops_pct', _record(OPS, engine='core')) is None
