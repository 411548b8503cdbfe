"""The Chebyshev step kernel's roofline (``rooflines/ell_step.py``) and
its reader (``metrics/ell_step.roofline_pct.py``)."""

from types import SimpleNamespace

import pytest

from portbench import registry
from portbench.rooflines import e1, ell_step
from portbench.tracing import Trace

BW = 3.35e12
PEAKS = {'hbm_bytes_per_s': BW}
FE = {'n': 139179, 'nnz': 7819533, 'noff': None, 'nnz_b': 7819533}
STEP_F32 = ('void (anonymous namespace)::ell_step_kernel<float, float, '
            'float, 4>(int const*, float const*, float const*, float*, '
            'float*, float*, float, float, (anonymous namespace)::Walk, '
            'bool, bool)')
STEP_F64 = STEP_F32.replace('float, float, float, 4', 'float, double, '
                            'double, 2')
E1_F32 = ('void (anonymous namespace)::ell_rows_kernel<float, float, float, '
          '4>(int const*, float const*, float const*, float*, '
          '(anonymous namespace)::Walk)')
A = 7819533 * 8 + 139180 * 4        # values, columns and row pointer
BLOCK = 139179 * 16 * 4             # an (n, 16) f32 iterate


@pytest.mark.parametrize('first, last, blocks', [
    (False, False, 6), (True, False, 5), (False, True, 3), (True, True, 2)])
def test_a_step_counts_a_and_the_iterates_it_moves(first, last, blocks):
    """A middle step of the finite-element cell at m = 16: 116.6 MB,
    0.0348 ms at 3.35 TB/s; the last step gathers nothing."""
    want = (0 if last else A) + blocks * BLOCK
    assert ell_step.step_bytes(STEP_F32, FE, 16, first, last) == want
    if not (first or last):
        assert want == 116557720
        assert round(1e3 * want / BW, 4) == 0.0348


def test_a_launch_counts_the_mean_of_its_apply():
    """degree 32: a first, 30 middle and a last step."""
    mean = ell_step.launch_bytes(STEP_F32, FE, 16, 32)
    assert mean == (31 * A + (5 + 30 * 6 + 3) * BLOCK) / 32
    assert mean == 113472007.25
    assert ell_step.launch_bytes(STEP_F32, FE, 16, 1) == 2 * BLOCK
    assert ell_step.step_bytes(STEP_F64, FE, 8, False, False) == \
        7819533 * 8 + 139180 * 4 + 6 * 139179 * 8 * 8


def test_the_step_and_e1_read_only_their_own_launches():
    assert ell_step.launch_bytes(E1_F32, FE, 16, 32) is None
    assert ell_step.step_bytes(E1_F32, FE, 16, False, False) is None
    assert e1.launch_bytes(STEP_F32, FE, 16) is None


def _record(device_ops, cell=None, peaks=PEAKS):
    trace = Trace(device_ops, [], [(0.0, 1.0)])
    cell = cell or {'block': 16, 'chebyshev': {'degree': 32}}
    return SimpleNamespace(trace=trace, stats=FE, cell=cell, peaks=peaks)


def test_the_reader_sums_bounds_over_times():
    read = registry.module('metrics', 'ell_step.roofline_pct').read
    ops = [(STEP_F32, 0.1 * i, 0.1 * i + 8e-5) for i in range(1, 5)]
    ops += [(E1_F32, 0.6, 0.7), ('Memcpy DtoH', 0.8, 0.9)]
    got = read(_record(ops))
    assert got == pytest.approx(100 * 113472007.25 / BW / 8e-5, rel=1e-9)
    assert 0 < got < 100


def test_the_reader_finds_nothing_without_the_step_kernel():
    """The parent's trace, a run with no peaks, a cell with no
    recurrence."""
    read = registry.module('metrics', 'ell_step.roofline_pct').read
    assert read(_record([(E1_F32, 0.1, 0.2)])) is None
    step = [(STEP_F32, 0.1, 0.2)]
    assert read(_record(step, peaks=None)) is None
    assert read(_record(step, cell={'block': 16})) is None
    assert read(SimpleNamespace(trace=None, stats=FE, peaks=PEAKS,
                                cell={'block': 16,
                                      'chebyshev': {'degree': 32}})) is None


def test_the_metric_reads_the_cells_of_fixed_width():
    """Listed where every apply has the cell's block width (the device
    LOBPCG), not where the core Solver narrows it."""
    bench = registry.benchmark()
    entry, = [m for m in bench['per_layer']
              if m['name'] == 'ell_step.roofline_pct']
    for name in entry['workloads']:
        assert registry.load('workloads', name)['engine'] != 'core'
