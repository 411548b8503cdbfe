"""Host<->device link measurement and the orchestration decision.

The port's twin of ``raleigh_tpu/utils/link.py``.  The shift-invert
iteration factorizes and solves on the host (native LDL^T) but can run its
block algebra either on the host (dense_numpy) or on the card
(dense_torch), with the per-iteration solve block crossing the link both
ways.  Which is faster depends on the link, so it is measured once per
process and device: pinned host<->device copies timed with CUDA events,
and small round trips (a copy up, a copy down, the wait between) timed on
the host clock.  On a card in the same host the copies run at PCIe or
NVLink rates and the device algebra wins by orders of magnitude.
"""

import time

import torch

_CACHE = {}


def probe_link(device=None, nbytes=4 << 20, force=False):
    """Timed transfers between the host and ``device`` (the card unless it
    names another): a dict with ``up_bytes_per_s``, ``down_bytes_per_s``,
    ``rtt_s``, ``colocated`` (True for the CPU, where there is no link)
    and ``platform``.  Cached per process and device."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    key = str(device)
    if key in _CACHE and not force:
        return _CACHE[key]
    if device.type == 'cpu':
        _CACHE[key] = dict(colocated=True, up_bytes_per_s=float('inf'),
                           down_bytes_per_s=float('inf'), rtt_s=0.0,
                           platform='cpu')
        return _CACHE[key]
    small = torch.zeros(8, dtype=torch.float32).pin_memory()
    back = torch.empty_like(small).pin_memory()
    dsmall = small.to(device)
    back.copy_(dsmall)               # warm the copy paths
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        dsmall.copy_(small)
        back.copy_(dsmall)           # waits for the card
        rtts.append(time.perf_counter() - t0)
    host = torch.empty(nbytes // 4, dtype=torch.float32).pin_memory()
    dev = torch.empty_like(host, device=device)
    stream = torch.cuda.current_stream(device)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.cuda.device(device):
        dev.copy_(host, non_blocking=True)
        marks[0].record(stream)
        dev.copy_(host, non_blocking=True)
        marks[1].record(stream)
        host.copy_(dev, non_blocking=True)
        marks[2].record(stream)
    marks[2].synchronize()
    t_up = max(marks[0].elapsed_time(marks[1]) * 1e-3, 1e-9)
    t_down = max(marks[1].elapsed_time(marks[2]) * 1e-3, 1e-9)
    _CACHE[key] = dict(colocated=False,
                       up_bytes_per_s=nbytes / t_up,
                       down_bytes_per_s=nbytes / t_down,
                       rtt_s=min(rtts), platform=device.type)
    return _CACHE[key]


def choose_orchestration(n, block, itemsize=8, host_gflops=4.0,
                         device=None):
    """'device' when moving the per-iteration solve block across the
    link costs less than the host block algebra it would replace, else
    'host'.

    Model (the JAX package's): each iteration ships the solve's RHS and
    solution blocks (2 * n * block * itemsize bytes) plus ~4
    synchronization round trips; the host block algebra it displaces is
    ~12 n block^2 flops (Grams, orthogonalization, residuals) at
    ``host_gflops``."""
    link = probe_link(device)
    if link['colocated']:
        return 'device'
    bytes_per_iter = 2.0 * n * block * itemsize
    t_link = (bytes_per_iter / min(link['up_bytes_per_s'],
                                   link['down_bytes_per_s'])
              + 4.0 * link['rtt_s'])
    t_host = 12.0 * n * block * block / (host_gflops * 1e9)
    return 'host' if t_link > t_host else 'device'
