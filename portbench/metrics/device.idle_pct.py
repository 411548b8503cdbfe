"""The share of the traced window in which no device operation ran (the
union of kernel, copy and fill intervals), in %."""


def read(record):
    t = record.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
