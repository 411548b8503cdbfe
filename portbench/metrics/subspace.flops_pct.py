"""The dense PCA's least work (``rooflines/subspace_pca.py``, from the
inputs' m, n and the workload's npc, oversample and iters) at the card's
f32 peak, over the device's busy time in the traced window
(``Trace.busy_s``: the union of every kernel, copy and fill), in %."""

from ..registry import module


def read(record):
    t = record.trace
    if t is None or not record.peaks or t.busy_s <= 0:
        return None
    wl = record.cell
    roof = module('rooflines', 'subspace_pca')
    work = roof.flops(record.stats['m'], record.stats['n'], wl['npc'],
                      wl['oversample'], wl['iters'])
    return 100.0 * t.solves * work / roof.F32_PEAK / t.busy_s
