"""The program's spans in a traced run (``spans.py``) and the readers of
the per-layer metrics that read them: self times by layer on a hand-made
trace, nothing read where the program records no span, and on the card
the spans on the device trace's clock."""

from types import SimpleNamespace

import pytest

from portbench import registry, spans, tracing

# the metrics that read the program's spans, and the layer of each time
TIMES = {'interfaces.host_ms': 'interfaces',
         'lobpcg.host_ms': 'device solver',
         'core_solver.host_ms': 'core solver',
         'dense.host_ms': 'block algebra',
         'chebyshev.host_ms': 'Chebyshev',
         'sparse.host_ms': 'sparse ops',
         'host.sync_ms': 'host issue'}
READERS = sorted(TIMES) + ['host.syncs_per_solve']

# two solves in the window [10, 40]: one on the core Solver, one on the
# device LOBPCG; a solve before the window; and host operations of torch
HOST = [
    ('raleigh.partial_hevp', 0.0, 5.0),
    ('raleigh.sync', 2.0, 3.0),
    ('raleigh.partial_hevp', 10.0, 20.0),
    ('raleigh.core_solver', 11.0, 19.0),
    ('raleigh.dense.dot', 12.0, 14.0),
    ('aten::mm', 12.2, 12.4),
    ('raleigh.sync', 13.0, 13.5),
    ('raleigh.chebyshev', 15.0, 18.0),
    ('raleigh.spmm', 15.5, 16.5),
    ('raleigh.dense.fill', 17.0, 17.5),
    ('raleigh.dense.copy', 17.1, 17.2),
    ('raleigh.partial_hevp', 30.0, 40.0),
    ('raleigh.lobpcg', 31.0, 39.0),
    ('raleigh.lobpcg.step', 32.0, 36.0),
    ('raleigh.lobpcg.eigh', 33.0, 34.0),
    ('raleigh.spmm', 34.5, 35.0),
    ('raleigh.sync', 37.0, 38.0),
    ('cudaStreamSynchronize', 37.1, 37.9),
]
# seconds of self time by layer over the window
SELF = {'interfaces': 2.0 + 2.0,
        'core solver': 8.0 - 2.0 - 3.0,
        'block algebra': (2.0 - 0.5) + 0.5,
        'host issue': 0.5 + 1.0,
        'Chebyshev': 3.0 - 1.0 - 0.5,
        'sparse ops': 1.0 + 0.5,
        'device solver': (8.0 - 4.0 - 1.0) + (4.0 - 1.0 - 0.5) + 1.0}


def _record(host_ops):
    trace = tracing.Trace([('kernel', 12.0, 13.0)], host_ops,
                          [(10.0, 20.0), (30.0, 40.0)])
    return SimpleNamespace(trace=trace)


def test_self_times_by_layer_add_up_to_the_entry():
    record = _record(HOST)
    assert spans.self_seconds(record.trace) == pytest.approx(SELF)
    total = 0.0
    for name, where in TIMES.items():
        value = registry.module('metrics', name).read(record)
        assert value == pytest.approx(1e3 * SELF[where] / 2)
        total += value
    # the seven times add up to the time inside raleigh.partial_hevp
    inside = sum(e - s for n, s, e in spans.spans(record.trace)
                 if n == 'raleigh.partial_hevp')
    assert inside == 20.0
    assert total == pytest.approx(1e3 * inside / 2)
    # two transfers in the window (one before it is not counted)
    syncs = registry.module('metrics', 'host.syncs_per_solve').read(record)
    assert syncs == 1.0


def test_span_names_map_to_their_layers():
    assert spans.layer('raleigh.lobpcg.eigh') == 'device solver'
    assert spans.layer('raleigh.dense.conjugation_beta') == 'block algebra'
    assert spans.layer('raleigh.spmm') == 'sparse ops'
    assert spans.layer('raleigh.spmmx') is None
    assert spans.layer('aten::mm') is None


@pytest.mark.parametrize('name', READERS)
def test_a_reader_reads_nothing_without_the_programs_spans(name):
    read = registry.module('metrics', name).read
    assert read(SimpleNamespace(trace=None)) is None
    torch_only = [op for op in HOST if not op[0].startswith('raleigh.')]
    assert read(_record(torch_only)) is None
    # spans outside the window are not read either
    assert read(_record(HOST[:2] + torch_only)) is None


def test_every_reader_has_its_entry():
    bench = registry.benchmark()
    entries = {m['name']: m for m in bench['per_layer']}
    for name in READERS:
        entry = entries[name]
        assert entry['source'] == 'program_span'
        assert entry['moves'] == 'solve_ms'
        if name in TIMES:
            assert entry['layer'] == TIMES[name]
            assert entry['unit'] == 'ms/solve'


@pytest.mark.gpu
def test_the_spans_share_the_device_clock(card, tiny_cell):
    """A traced solve of the FE core Solver cell on the card, whose every
    sparse apply is an eager E1 launch (f32 x f64 in the recurrence, f64 x
    f64 for K and M; the device LOBPCG replays its applies in CUDA graphs,
    where no span fires): each E1 launch is one ``raleigh.spmm`` span,
    every E1 kernel starts after the start of the span that launched it
    (launches and kernels keep their order on the one stream), and no
    span of the program appears among the device operations."""
    from portbench import harness
    cell = tiny_cell('shipsec1_fe.core6')
    program = cell.task.Program(cell, cell.make(2 ** 31 + 29))
    program.solve()
    trace, solves = harness.traced(program, 1)
    assert solves[-1].status == 0
    e1 = sorted(s for n, s, _ in trace.device_ops
                if 'ell_rows_kernel' in n and 'prev::' not in n)
    spmm = sorted(s for n, s, _ in trace.host_ops if n == 'raleigh.spmm')
    assert e1 and len(e1) == len(spmm)
    assert all(k >= s for k, s in zip(e1, spmm))
    assert not [n for n, _, _ in trace.device_ops if n.startswith('raleigh')]
    assert spans.self_seconds(trace)['sparse ops'] > 0
