"""Device time of PyTorch's elementwise kernels on bfloat16 data in the
traced window, in ms a solve: ``eager.elementwise_ms`` read over the
kernels whose names carry the bfloat16 type alone.  These are the eager
passes of a Chebyshev recurrence that streams bfloat16 iterates, which
only the DIA rule makes.  On the card (torch 2.11) they are the adds and
subtractions (``CUDAFunctor_add<c10::BFloat16>``), the scalings
(``AUnaryFunctor``/``BUnaryFunctor<c10::BFloat16, ...>``) and the cast in
(``bfloat16_copy_kernel_cuda``).  The cast out is a
``direct_copy_kernel_cuda`` named by its float output alone, as the
solver's casts from float64 are, so it is not counted.  K1's bfloat16
launches (``dia_lanes_kernel<__nv_bfloat16>``) are no elementwise
kernel."""

from types import SimpleNamespace

from .. import registry


def read(record):
    t = record.trace
    if t is None:
        return None
    kernels = [(n, s) for n, s in t.kernels() if 'bfloat16' in n.lower()]
    bf16 = SimpleNamespace(kernels=lambda: kernels, solves=t.solves)
    eager = registry.module('metrics', 'eager.elementwise_ms')
    return eager.read(SimpleNamespace(trace=bf16))
