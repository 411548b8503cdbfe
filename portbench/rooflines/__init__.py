"""A kernel's least time on the card, a launch at a time: each file here
gives ``launch_bytes(name, stats, m)``, the bytes one launch of the kernel
named ``name`` (as the profiler names it) has to move for these inputs,
or None when ``name`` is not that kernel.  Each input byte is counted read
once and each output byte written once, and only what the inputs need:
a layout's padding is not counted."""

# bytes of the C++ types in the kernels' template names
TYPE_BYTES = {'float': 4, 'double': 8, '__nv_bfloat16': 2, 'bf16': 2}


def share(trace, stats, m, launch_bytes, peaks):
    """100 x (the launches' bytes over the card's bandwidth) / (their
    device time) for the kernel of ``launch_bytes``, or None when the
    window holds no launch of it or the card has no entry in the peaks
    table."""
    if trace is None or not peaks:
        return None
    need = took = 0.0
    for name, seconds in trace.kernels():
        nbytes = launch_bytes(name, stats, m)
        if nbytes is not None:
            need += nbytes / peaks['hbm_bytes_per_s']
            took += seconds
    return 100.0 * need / took if took > 0 else None
