"""The reader of ``lobpcg.replay_pct`` on hand-made traces: the share of
the LOBPCG step's pieces that ran as CUDA graph replays, and nothing read
where the window holds no piece."""

from types import SimpleNamespace

import pytest

from portbench import registry, tracing


def _read(host_ops):
    trace = tracing.Trace([('kernel', 12.0, 13.0)], host_ops,
                          [(10.0, 20.0), (30.0, 40.0)])
    return registry.module('metrics', 'lobpcg.replay_pct').read(
        SimpleNamespace(trace=trace))


def _step(start, kinds):
    """A ``raleigh.lobpcg.step`` span at ``start`` holding one span of each
    kind in ``kinds`` ('replay', 'capture' or 'piece'), with an eigh
    between them."""
    ops = [('raleigh.lobpcg.step', start, start + 1.0)]
    for i, kind in enumerate(kinds):
        t = start + 0.2 * i
        ops.append(('raleigh.lobpcg.' + kind, t, t + 0.1))
        ops.append(('raleigh.lobpcg.eigh', t + 0.12, t + 0.18))
    return ops


def test_replays_only_read_100():
    ops = [('raleigh.partial_hevp', 10.0, 20.0), ('raleigh.lobpcg', 11.0, 19.0)]
    ops += _step(12.0, ['replay'] * 4) + _step(14.0, ['replay'] * 4)
    assert _read(ops) == pytest.approx(100.0)


def test_eager_pieces_count_against_replays():
    # in the window: one eager step (4 pieces), then one step captured and
    # replayed (4 captures, 4 replays) and two steps replayed; a step
    # before the window is not counted
    ops = [('raleigh.lobpcg', 0.0, 5.0)] + _step(1.0, ['piece'] * 4)
    ops += [('raleigh.lobpcg', 11.0, 19.0)] + _step(12.0, ['piece'] * 4)
    ops += _step(14.0, ['capture', 'replay'] * 4)
    ops += _step(16.0, ['replay'] * 4) + _step(31.0, ['replay'] * 4)
    assert _read(ops) == pytest.approx(100.0 * 12 / 16)
    eager = [('raleigh.lobpcg', 11.0, 19.0)] + _step(12.0, ['piece'] * 4)
    assert _read(eager) == 0.0


def test_no_piece_reads_nothing():
    # the program's spans without pieces (a step of a program that splits
    # none), spans of no program, and no trace
    assert _read([('raleigh.lobpcg', 11.0, 19.0),
                  ('raleigh.lobpcg.step', 12.0, 13.0),
                  ('raleigh.lobpcg.eigh', 12.2, 12.4)]) is None
    assert _read([('aten::mm', 12.0, 13.0)]) is None
    reader = registry.module('metrics', 'lobpcg.replay_pct')
    assert reader.read(SimpleNamespace(trace=None)) is None
