"""The dense PCA cell's pieces: its task through the registry and the
harness on the host at a small size, with no look for a card; each of its
faults (``pca_faults.py``) coming out not correct; the engine's FLOP count
(``rooflines/subspace_pca.py``); and its three readers on hand-made
traces."""

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, pca_faults, registry
from portbench.rooflines import subspace_pca
from portbench.tasks import pca as pca_task
from portbench.tracing import Trace

CELL = 'lfw_pca.npc800'
# the recipe at 600 x 2,000, rank 256, 40 components, on the host
SMALL = {'m': 600, 'n': 2000, 'rank': 256, 'device': 'cpu'}


def _cell():
    cell = harness.Cell(CELL, params=SMALL)
    cell.workload = dict(cell.workload, npc=40)
    return cell


def _run(trace=0, seconds=0.0, seed=2 ** 31 + 17):
    out = harness.run(_cell(), seed, seconds, trace, time.time(),
                      device='cpu')
    metrics = harness.metrics(out, registry.benchmark(), CELL, trace)
    line = harness.result(out, metrics, {'platform': 'cpu', 'kind': 'cpu',
                                         'count': 1, 'memory_peak_bytes': 0},
                          trace)
    return out, line


def test_the_task_loads_through_the_registry():
    cell = harness.Cell(CELL)
    assert cell.task_name == 'pca'
    assert cell.task is registry.module('tasks', 'pca')
    assert cell.task.NUMBERS == ('err_excess', 'sv_err', 'ortho',
                                 'trans_ortho')
    assert set(cell.workload['limits']) == set(cell.task.NUMBERS)
    assert all(v is not None for v in cell.workload['limits'].values())
    assert cell.config['params']['m'] == cell.config['sizes']['m'] == 12000
    assert cell.config['params']['n'] == cell.config['sizes']['n'] == 39375
    assert cell.config['sizes']['data_bytes'] == 4 * 12000 * 39375
    assert cell.config['sizes']['factors_bytes'] == \
        4 * (39375 + 12000 * 800 + 800 * 39375)


def test_a_window_on_the_host():
    out, line = _run(seconds=0.3)
    assert line['correct'] is True and line['failed'] == 0, out.lines
    assert list(line['checks']) == ['err_excess', 'sv_err', 'ortho',
                                    'trans_ortho', 'failed_solves']
    assert set(line['metrics']) == {'solve_ms', 'setup_s'}
    assert out.record.stats == {'m': 600, 'n': 2000}
    assert all(s.status == 0 and s.iterations is None for s in out.solves)
    kept = [s for s in out.solves if s.x is not None]
    assert 1 <= len(kept) <= harness.SAMPLED_SOLVES


def test_a_traced_run_on_the_host_reads_the_engines_spans():
    """On the host the trace holds no device operation and the card no
    peak: the two device readers read nothing, the span reader reads."""
    out, line = _run(trace=1)
    assert line['correct'] is True, out.lines
    assert set(line['metrics']) == {'subspace.host_ms'}
    assert line['metrics']['subspace.host_ms']['value'] > 0
    assert out.attempted == 1 + out.record.cell['trace_solves']


@pytest.mark.parametrize('fault', [None] + sorted(pca_faults.FAULTS))
def test_a_fault_comes_out_not_correct(fault):
    with pca_faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        out, line = _run()
    assert line['correct'] is (fault is None), out.lines


def test_a_wrong_shape_or_a_value_not_finite_fails_outright():
    x = (np.zeros((1, 5)), np.zeros((4, 2)), np.zeros((2, 5)))
    assert pca_task.structural(x, 4, 5, 2) is None
    assert 'shapes' in pca_task.structural(x, 4, 5, 3)
    bad = (x[0], x[1], np.full((2, 5), np.nan))
    assert 'finite' in pca_task.structural(bad, 4, 5, 2)
    cell = SimpleNamespace(config={'reference': {'name': 'pca64'}},
                           workload={'npc': 2}, root=registry.ROOT)
    solves = [SimpleNamespace(x=None), SimpleNamespace(x=bad)]
    numbers, failed, reasons = pca_task.judge(
        cell, {'A': torch.zeros((4, 5))}, solves, 'cpu')
    assert failed == 1 and list(reasons) == [1]
    assert set(numbers.values()) == {None}


def test_the_flop_count_at_the_full_size():
    """12,000 x 39,375, npc 800, oversample 64, iters 6: the hand sum."""
    m, n, k, l = 12000, 39375, 800, 864
    gram = m * (m + 1) * n
    products = 2 * m * n + 8 * 2 * m * m * l + 2 * l * m * l + 2 * m * l * l \
        + 2 * n * m * k
    qr = 7 * (4 * m * l * l - 4 * l ** 3 // 3)
    assert subspace_pca.flops(m, n, k, 64, 6) == gram + products + qr \
        == 8_698_708_220_256
    assert round(8_698_708_220_256 / subspace_pca.F32_PEAK, 3) == 0.130
    assert subspace_pca.F32_PEAK == pytest.approx(66.9e12, rel=1e-3)


def _record(device_ops, host_ops=(), peaks=True):
    trace = Trace(list(device_ops), list(host_ops), [(10.0, 20.0),
                                                      (20.0, 30.0)])
    return SimpleNamespace(
        trace=trace, peaks={'hbm_bytes_per_s': 3.35e12} if peaks else None,
        stats={'m': 12000, 'n': 39375},
        cell=registry.load('workloads', CELL))


def test_the_flop_share_is_the_least_work_over_busy_time():
    read = registry.module('metrics', 'subspace.flops_pct').read
    work = subspace_pca.flops(12000, 39375, 800, 64, 6)
    busy = 2 * work / subspace_pca.F32_PEAK / 0.4      # 40% of the peak
    rec = _record([('gemm', 11.0, 11.0 + busy / 2),
                   ('Memcpy DtoH', 21.0, 21.0 + busy / 2)])
    assert read(rec) == pytest.approx(40.0)
    assert read(_record([('gemm', 11.0, 12.0)], peaks=False)) is None
    assert read(SimpleNamespace(trace=None, peaks=None)) is None


QR_NAMES = ('void geqr2_smem<float, float, 8, 4>(int, int, float*, int, '
            'float*, int)', 'void larft_gemv_kernel<float, 4>(int, int, '
            'float const*, int, float*)', 'orgqr_sm90_kernel')


def test_the_qr_time_reads_cusolvers_qr_kernels():
    read = registry.module('metrics', 'subspace.qr_ms').read
    ops = [(name, 11.0 + i, 11.5 + i) for i, name in enumerate(QR_NAMES)]
    ops += [('ampere_sgemm_128x64_nn', 15.0, 18.0)]
    assert read(_record(ops)) == pytest.approx(1e3 * 1.5 / 2)
    assert read(_record(ops[-1:])) is None


def test_the_engines_host_time_is_its_self_time():
    read = registry.module('metrics', 'subspace.host_ms').read
    host = [('raleigh.pca', 10.0, 19.0),
            ('raleigh.subspace', 10.5, 18.5),
            ('raleigh.subspace.gram', 11.0, 12.0),
            ('aten::mm', 11.2, 11.4),
            ('raleigh.subspace.iterate', 12.0, 13.0),
            ('raleigh.subspace.rr', 13.0, 14.0),
            ('raleigh.subspace.factors', 14.0, 15.0),
            ('raleigh.sync', 16.0, 18.0),
            ('raleigh.subspace', 21.0, 25.0),
            ('raleigh.sync', 22.0, 24.0),
            ('raleigh.subspace', 5.0, 6.0)]            # outside the window
    # 8 s in the first engine span less 2 s of sync, 4 less 2 in the second
    assert read(_record([], host)) == pytest.approx(1e3 * (6.0 + 2.0) / 2)
    # a program without the engine's spans (the pca span alone)
    assert read(_record([], host[:1])) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_the_readers_have_their_entries():
    bench = registry.benchmark()
    entries = {m['name']: m for m in bench['per_layer']}
    for name, source, layer in (
            ('subspace.flops_pct', 'device_trace', 'kernels'),
            ('subspace.qr_ms', 'device_trace', 'subspace engine'),
            ('subspace.host_ms', 'program_span', 'subspace engine')):
        entry = entries[name]
        assert (entry['source'], entry['layer'], entry['moves'],
                entry['workloads']) == (source, layer, 'solve_ms', [CELL])
