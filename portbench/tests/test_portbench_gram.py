"""The Gram kernel's roofline (``rooflines/gram.py``) and its metric
(``metrics/gram.roofline_pct.py``) on kernel names as the profiler gives
them, and the readers that must and must not count the kernel."""

from types import SimpleNamespace

import pytest

from portbench import registry
from portbench.rooflines import gram, share
from portbench.tracing import Trace

BW = 3.35e12
LAP = {'n': 1280000}
GRAM_16 = ('void (anonymous namespace)::gram_gemm_kernel<float, 16, 16, '
           'false>(float const*, float const*, float*, long, long)')
SELF_16 = GRAM_16.replace('16, 16, false', '16, 16, true')
GRAM_48 = GRAM_16.replace('16, 16, false', '48, 48, false')
SUM_48 = ('void (anonymous namespace)::gram_gemm_sum_kernel<float, 48, 48>('
          'float const*, float*, int)')
CUBLAS = ('sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_'
          'warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel_trt')
ELEMENTWISE = ('void at::native::vectorized_elementwise_kernel<4, '
               'at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> '
               '>(int, at::native::CUDAFunctor_add<float>, '
               'std::array<char*, 3ul>)')


def test_a_grams_bytes_by_its_name():
    """Both blocks read once, a self-Gram's one block once, G written: at
    n = 1.28M the (48, 48) Gram is 491.5 MB and its output."""
    assert gram.launch_bytes(GRAM_48, LAP, 16) == \
        96 * 1280000 * 4 + 48 * 48 * 4 == 491529216
    assert gram.launch_bytes(GRAM_16, LAP, 16) == 32 * 1280000 * 4 + 1024
    assert gram.launch_bytes(SELF_16, LAP, 16) == 16 * 1280000 * 4 + 1024
    assert round(1e3 * gram.launch_bytes(GRAM_48, LAP, 16) / BW, 4) == \
        0.1467
    assert gram.launch_bytes(SUM_48, LAP, 16) == 0
    for name in (CUBLAS, ELEMENTWISE, 'gram_gemm_kernel'):
        assert gram.launch_bytes(name, LAP, 16) is None


def test_the_share_counts_the_sum_launch_s_time():
    ops = [(GRAM_48, 0.1, 0.1 + 2.0e-4), (SUM_48, 0.2, 0.2 + 0.1e-4),
           (SELF_16, 0.3, 0.3 + 0.4e-4), (CUBLAS, 0.4, 0.5)]
    trace = Trace(ops, [], [(0.0, 1.0)])
    got = share(trace, LAP, 16, gram.launch_bytes, {'hbm_bytes_per_s': BW})
    want = (491529216 + 81921024) / BW / 2.5e-4
    assert got == pytest.approx(100 * want, rel=1e-9)


def _reader(name, ops):
    trace = Trace(ops, [], [(0.0, 1.0), (1.0, 2.0)])
    record = SimpleNamespace(trace=trace, stats=LAP, cell={'block': 16},
                             peaks={'hbm_bytes_per_s': BW})
    return registry.module('metrics', name).read(record)


def test_the_gemm_reader_counts_the_kernel_and_the_eager_one_does_not():
    """``dense.gemm_ms`` (names with gemm, gemv, nvjet or xmma) counts
    both of the Gram kernel's launches; ``eager.elementwise_ms`` neither."""
    ops = [(GRAM_16, 0.1, 0.1 + 6e-5), (SUM_48, 0.2, 0.2 + 1e-5),
           (ELEMENTWISE, 0.3, 0.3 + 3e-5)]
    assert _reader('dense.gemm_ms', ops) == pytest.approx(1e3 * 7e-5 / 2)
    assert _reader('eager.elementwise_ms', ops) == \
        pytest.approx(1e3 * 3e-5 / 2)


def test_the_metric_reads_the_laplacian_alone_and_nothing_without_it():
    entry, = [m for m in registry.benchmark()['per_layer']
              if m['name'] == 'gram.roofline_pct']
    assert entry['workloads'] == ['lap3d_1p28m.lobpcg4']
    assert (entry['layer'], entry['moves'], entry['better']) == \
        ('kernels', 'solve_ms', 'higher')
    assert _reader('gram.roofline_pct', [(CUBLAS, 0.1, 0.2)]) is None
    got = _reader('gram.roofline_pct', [(GRAM_16, 0.1, 0.1 + 1e-4)])
    assert got == pytest.approx(100 * 163841024 / BW / 1e-4)
