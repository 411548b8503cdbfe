"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository.  Tests that need the card carry the ``gpu``
marker, decide inside the test whether there is one, and skip without
it: ``python -m pytest portbench/tests -q -m gpu`` on the card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line('markers', 'gpu: needs an NVIDIA card')


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.cuda.get_device_name(0)


# each configuration at a size the host runs in seconds, on the kernels'
# plain versions
SMALL = {'shipsec1_fe': {'nc': 12}, 'lap3d_1p28m': {'grid': [16, 17, 18]}}


@pytest.fixture
def tiny_cell():
    """``make(workload, root=...)``: the cell at its configuration's small
    size."""
    from portbench import harness, registry

    def make(name, root=registry.ROOT):
        wl = registry.load('workloads', name, root)
        return harness.Cell(name, root=root, params=SMALL.get(wl['config']))
    return make


@pytest.fixture
def run_tiny(tiny_cell):
    """``run(workload, trace=0, seconds=0.3, seed=..., root=...)``: one
    run of the harness on the host at the configuration's small size, with
    no look for a card; returns (harness output, result line)."""
    import time

    from portbench import harness, registry

    def run(name, trace=0, seconds=0.3, seed=2 ** 31 + 17,
            root=registry.ROOT):
        cell = tiny_cell(name, root)
        out = harness.run(cell, seed, seconds, trace, time.time(),
                          device='cpu')
        bench = registry.benchmark(root)
        metrics = harness.metrics(out, bench, name, trace, root)
        line = harness.result(out, metrics, {'platform': 'cpu', 'kind': 'cpu',
                                             'count': 1,
                                             'memory_peak_bytes': 0}, trace)
        return out, line
    return run
