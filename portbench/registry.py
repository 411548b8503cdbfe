"""Finding the benchmark's pieces by name.  Every piece is a file under
the benchmark's folder (``root``), so a new configuration, cell, metric,
maker, reference or roofline is a new file and an entry in
``BENCHMARK.json``, never an edit."""

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load(kind, name, root=ROOT):
    """The JSON file ``<root>/<kind>/<name>.json`` (a configuration or a
    workload)."""
    path = Path(root) / kind / (name + '.json')
    if not path.is_file():
        raise KeyError('no %s named %r (%s)' % (kind[:-1], name, path))
    with open(path) as f:
        return json.load(f)


def module(kind, name, root=ROOT):
    """The module ``<root>/<kind>/<name>.py`` (a maker, a reference, a
    metric's reader or a roofline), loaded by its path: a name may hold
    dots, as metric names do.  It is loaded as a submodule of this
    package, so that its relative imports find the benchmark's own
    modules."""
    path = Path(root) / kind / (name + '.py')
    if not path.is_file():
        raise KeyError('no %s module named %r (%s)' % (kind, name, path))
    qual = '%s.%s.%s' % (__package__, kind, name.replace('.', '_'))
    known = sys.modules.get(qual)
    if known is not None and Path(known.__file__) == path:
        return known
    importlib.import_module('%s.%s' % (__package__, kind))
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    """``BENCHMARK.json``, which sits beside the benchmark's folder at the
    root of the checkout."""
    with open(Path(root).parent / 'BENCHMARK.json') as f:
        return json.load(f)


def metrics_for(bench, cell, kind):
    """The entries of ``bench[kind]`` ('end_to_end' or 'per_layer') that
    cell ``cell`` reports: those with no ``workloads`` key, and those that
    list it."""
    return [m for m in bench[kind]
            if 'workloads' not in m or cell in m['workloads']]
