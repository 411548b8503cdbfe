"""On the card: the control of each cell (the program on its
lower-precision path, as the workload file names it) comes out not
correct, where the program as the configuration states it comes out
correct, at the cell's own size.  ``python -m pytest portbench/tests -q
-m gpu``; skipped without a card."""

import time

import pytest

from portbench import harness, registry

SEED = 2 ** 31 + 101


@pytest.mark.gpu
@pytest.mark.parametrize('name', [w['name'] for w in
                                  registry.benchmark()['workloads']])
@pytest.mark.parametrize('control', [False, True])
def test_the_control_fails_where_the_program_passes(card, name, control):
    cell = harness.Cell(name)
    out = harness.run(cell, SEED, 0.0, 0, time.time(),
                      control=cell.workload['control'] if control else None)
    assert out.correct is not control, out.lines
