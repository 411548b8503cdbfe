"""The 3D Laplacian's cell, ``lap3d_1p28m.lobpcg4``: the reader of the
bfloat16 recurrence's eager passes (``metrics/chebyshev.bf16_ms.py``) on
kernel names as the profiler gives them on the card, and the two
per-layer metrics that read the cell alone."""

from types import SimpleNamespace

import pytest

from portbench import registry
from portbench.tracing import Trace

CELL = 'lap3d_1p28m.lobpcg4'
ADD_BF16 = ('void at::native::vectorized_elementwise_kernel<8, '
            'at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, '
            '3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, '
            'std::array<char*, 3ul>)')
MUL_BF16 = ('void at::native::vectorized_elementwise_kernel<8, '
            'at::native::AUnaryFunctor<c10::BFloat16, c10::BFloat16, '
            'c10::BFloat16, at::native::binary_internal::MulFunctor<float> >, '
            'std::array<char*, 2ul> >(int, at::native::AUnaryFunctor<'
            'c10::BFloat16, c10::BFloat16, c10::BFloat16, '
            'at::native::binary_internal::MulFunctor<float> >, '
            'std::array<char*, 2ul>)')
CAST_IN = ('void at::native::vectorized_elementwise_kernel<8, '
           'at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::'
           '{lambda(float)#1}, std::array<char*, 2ul> >(int, '
           'at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::'
           '{lambda(float)#1}, std::array<char*, 2ul>)')
# the cast out of bfloat16: named by its float output alone, as a cast
# from float64 is
CAST_OUT = ('void at::native::unrolled_elementwise_kernel<'
            'at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::'
            '{lambda()#3}::operator()() const::{lambda()#7}::operator()() '
            'const::{lambda(float)#1}, std::array<char*, 2ul>, 4, '
            'TrivialOffsetCalculator<1, unsigned int>, '
            'TrivialOffsetCalculator<1, unsigned int>, '
            'at::native::memory::LoadWithCast<1>, '
            'at::native::memory::StoreWithCast<1> >(int)')
ADD_F32 = ADD_BF16.replace('c10::BFloat16', 'float').replace('<8,', '<4,')
K1_BF16 = ('void (anonymous namespace)::dia_lanes_kernel<__nv_bfloat16>('
           'float const*, __nv_bfloat16 const*, __nv_bfloat16*, int const*, '
           'long, long, long, long, bool)')


def _read(device_ops, solves=2):
    spans = [(float(i), float(i + 1)) for i in range(solves)]
    trace = Trace(device_ops, [], spans)
    read = registry.module('metrics', 'chebyshev.bf16_ms').read
    return read(SimpleNamespace(trace=trace))


def test_the_reader_sums_the_bf16_passes_a_solve():
    """The eager reader's sum over the kernels named with bfloat16: not
    f32 passes, K1 or the cast out."""
    ops = [(ADD_BF16, 0.1, 0.1 + 4e-5), (MUL_BF16, 0.2, 0.2 + 3e-5),
           (CAST_IN, 1.1, 1.1 + 2e-5), (ADD_BF16, 1.2, 1.2 + 4e-5),
           (ADD_F32, 0.3, 0.4), (K1_BF16, 0.5, 0.6), (CAST_OUT, 0.6, 0.7),
           ('Memcpy DtoH (Device -> Pageable)', 0.7, 0.8)]
    assert _read(ops) == pytest.approx(1e3 * 13e-5 / 2, rel=1e-12)


def test_the_reader_finds_nothing_without_bf16_passes():
    """An f32 recurrence, K1 alone, a run with no trace."""
    assert _read([(ADD_F32, 0.1, 0.2), (K1_BF16, 0.3, 0.4)]) is None
    read = registry.module('metrics', 'chebyshev.bf16_ms').read
    assert read(SimpleNamespace(trace=None)) is None


def test_the_k1_and_bf16_metrics_read_the_laplacian_alone():
    bench = registry.benchmark()
    entries = {m['name']: m for m in bench['per_layer']}
    for name in ('k1.roofline_pct', 'chebyshev.bf16_ms'):
        assert entries[name]['workloads'] == [CELL]
        assert entries[name]['moves'] == 'solve_ms'
    assert entries['chebyshev.bf16_ms']['layer'] == 'Chebyshev'
    assert entries['k1.roofline_pct']['layer'] == 'kernels'
    cell, = [w for w in bench['workloads'] if w['name'] == CELL]
    assert cell['chips'] == 1
    assert registry.load('workloads', CELL)['why'] == cell['why']
    config, = [c for c in bench['configs'] if c['name'] == cell['config']]
    assert config['reduced'] == []
    assert config['source'] == registry.load('configs',
                                             cell['config'])['source']
