"""A run with its timed path broken underneath comes out not correct,
for each fault a cell on one card can have (``faults.py``), on the host
at the small sizes, with no look for a card; the same run unbroken comes
out correct."""

import contextlib

import pytest

from portbench.faults import FAULTS

CELLS = ('lap3d_1p28m.lobpcg4', 'lap3d_1p28m.core4', 'shipsec1_fe.lobpcg6',
         'shipsec1_fe.core6')


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', [None] + sorted(FAULTS))
def test_a_fault_comes_out_not_correct(run_tiny, cell, fault):
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        out, line = run_tiny(cell, seconds=0.0)
    assert line['correct'] is (fault is None), out.lines
