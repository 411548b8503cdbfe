"""The port's spans (``utils/profiling.py``) on the CPU: with no profiler
recording a span is one shared null context and a solve records nothing;
under ``torch.profiler`` a generalized problem through ``partial_hevp``
gives each engine's spans, all inside ``raleigh.partial_hevp``; and
``device_trace`` writes them to its Chrome trace."""

import contextlib
import inspect
import json
import os

import numpy as np
import pytest
import scipy.sparse as scs
import torch
from torch.profiler import ProfilerActivity, profile

from raleigh_tpu_torch import Chebyshev, partial_hevp, spectral_bounds
from raleigh_tpu_torch.utils import profiling

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

# the spans each engine's solve gives (the core Solver's block algebra
# gives raleigh.dense.<method> spans besides)
EXPECTED = {
    'device': {'raleigh.partial_hevp', 'raleigh.lobpcg',
               'raleigh.lobpcg.step', 'raleigh.lobpcg.eigh',
               'raleigh.chebyshev', 'raleigh.spmm', 'raleigh.sync'},
    'core': {'raleigh.partial_hevp', 'raleigh.core_solver',
             'raleigh.dense.dot', 'raleigh.dense.fetch', 'raleigh.chebyshev',
             'raleigh.spmm', 'raleigh.sync'},
}


def _pencil():
    """A 1-D Laplacian pencil with a tridiagonal mass matrix, and the
    bounds of its preconditioner: the set-up, which runs before a traced
    solve (``spectral_bounds`` is a span of its own, outside the solve's)."""
    n = 300
    ones = np.ones(n - 1)
    a = scs.diags([-ones, 2 * np.ones(n), -ones], [-1, 0, 1], format='csr')
    b = scs.diags([0.1 * ones, np.ones(n), 0.1 * ones], [-1, 0, 1],
                  format='csr')
    return a, b, spectral_bounds(a)


def _solve(engine, pencil):
    """The three smallest eigenpairs of ``pencil`` on the CPU."""
    a, b, (lo, hi) = pencil
    t = Chebyshev(a, lo, hi, degree=8, device='cpu')
    np.random.seed(1)       # the core Solver's start block
    lmd, _, status = partial_hevp(a, B=b, T=t, which=3, engine=engine,
                                  device='cpu', verb=-1)
    assert status == 0 and len(lmd) >= 3
    return lmd


def test_a_span_off_is_one_null_context_and_records_nothing(monkeypatch):
    assert profiling.span('raleigh.a') is profiling.span('raleigh.b')
    assert isinstance(profiling.span('raleigh.a'), contextlib.nullcontext)
    opened = []

    def recording(name):
        opened.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(profiling, '_RecordFunctionFast', recording)
    pencil = _pencil()
    _solve('core', pencil)
    assert opened == []
    # the same solve under a profiler opens its spans through the guard
    with profile(activities=[ProfilerActivity.CPU]):
        _solve('core', pencil)
    assert opened[0] == 'raleigh.partial_hevp'
    assert 'raleigh.core_solver' in opened


@pytest.mark.parametrize('engine', ['device', 'core'])
def test_a_solve_gives_nested_spans(engine):
    pencil = _pencil()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lmd = _solve(engine, pencil)
    found = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith('raleigh.')]
    names = {n for n, _, _ in found}
    assert EXPECTED[engine] <= names
    other = 'raleigh.core_solver' if engine == 'device' else 'raleigh.lobpcg'
    assert other not in names
    outer = [(s, e) for n, s, e in found if n == 'raleigh.partial_hevp']
    assert len(outer) == 1
    start, end = outer[0]
    assert all(start <= s and e <= end for _, s, e in found)
    # the spans change nothing in the answer
    assert np.array_equal(lmd, _solve(engine, pencil))


def test_device_trace_holds_the_spans(tmp_path):
    logdir = str(tmp_path / 'trace')
    pencil = _pencil()
    with profiling.device_trace(logdir):
        _solve('device', pencil)
    with open(os.path.join(logdir, 'trace.json')) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    assert EXPECTED['device'] <= names


def test_a_spanned_function_keeps_its_face():
    assert partial_hevp.__name__ == 'partial_hevp'
    assert 'engine' in inspect.signature(partial_hevp).parameters
    assert 'status' in partial_hevp.__doc__

    @profiling.spanned('raleigh.test')
    def add(x, y=1):
        return x + y
    assert add(2, y=3) == 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert add(2) == 3
    assert [e.name for e in prof.events()] == ['raleigh.test']
