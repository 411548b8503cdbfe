"""The program's own spans in a traced run: the ``raleigh.*`` host events
that ``raleigh_tpu_torch/utils/profiling.py`` records around each layer of
a solve, read from ``Trace.host_ops`` (the same profiler session as the
device operations, so on the same clock).

Every instant inside a span belongs to the innermost span then open, and
so to that span's layer: a layer's self time is the time inside its spans
that no deeper span of another layer covers.  The layers' self times
therefore add up to the time inside the outermost spans, which in a solve
is ``raleigh.partial_hevp``.  Spans are clipped to the traced window."""

PREFIX = 'raleigh.'
SYNC = 'raleigh.sync'
# the layer of each family of spans: the span of that name and those
# under it ('raleigh.lobpcg.step' is of 'raleigh.lobpcg')
LAYERS = (('raleigh.partial_hevp', 'interfaces'),
          ('raleigh.lobpcg', 'device solver'),
          ('raleigh.core_solver', 'core solver'),
          ('raleigh.dense', 'block algebra'),
          ('raleigh.chebyshev', 'Chebyshev'),
          ('raleigh.spmm', 'sparse ops'),
          ('raleigh.sync', 'host issue'))


def layer(name):
    """The layer of the span ``name``, or None for a name of no layer."""
    for family, where in LAYERS:
        if name == family or name.startswith(family + '.'):
            return where
    return None


def spans(trace):
    """The program's spans in the window as (name, start, end), clipped to
    it, in order of start (an enclosing span before those it holds)."""
    out = [(n, max(s, trace.start), min(e, trace.end))
           for n, s, e in trace.host_ops if n.startswith(PREFIX)]
    out = [x for x in out if x[2] > x[1]]
    out.sort(key=lambda x: (x[1], -x[2]))
    return out


def self_seconds(trace):
    """{layer: seconds} of self time summed over the window, None when the
    window holds no span of the program."""
    found = spans(trace)
    if not found:
        return None
    took = {}
    open_ = []      # the spans that enclose the current one: [end, layer]
    for name, s, e in found:
        while open_ and open_[-1][0] <= s:
            open_.pop()
        here = layer(name)
        took[here] = took.get(here, 0.0) + (e - s)
        if open_:
            parent = open_[-1]
            took[parent[1]] -= min(e, parent[0]) - s
        open_.append([min(e, open_[-1][0]) if open_ else e, here])
    return took


def layer_ms(record, name):
    """The self time of layer ``name`` in ms a solve in the run's traced
    window, or None where the run has no trace, the window no span of the
    program, or the layer no span."""
    t = record.trace
    took = None if t is None else self_seconds(t)
    if took is None or name not in took:
        return None
    return 1e3 * took[name] / t.solves


def count(record, name):
    """Spans named ``name`` in the traced window a solve, or None where the
    run has no trace or the window no span of the program."""
    t = record.trace
    if t is None:
        return None
    found = spans(t)
    if not found:
        return None
    return sum(1 for n, _, _ in found if n == name) / t.solves
