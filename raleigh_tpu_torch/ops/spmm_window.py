"""DIA SpMM on row-layout operand blocks: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/dia_spmm.cu``) replaces the sliding-window Pallas
kernel ``raleigh_tpu/ops/spmm_window.py::build_dia_window_ring``.  Its
TPU-only machinery does not carry over: the DMA ring through VMEM (L1/L2
give a coalesced kernel the same halo reuse), and the Mosaic limits
``n % 128 == 0``, ``m % 8 == 0`` and two or more lane tiles — the kernel
takes any shape.

    y[r, i] = sum_k val[k, i] * x[r, i + offsets[k]],  zero outside [0, n)

``val`` (noff, n), ``x`` (m, n), ``offsets`` an int32 (noff,) tensor on
the same device.  On a CUDA tensor the wrapper launches the kernel (x f32
or bf16, val f32) or raises; only a CPU tensor takes the plain version.
"""

import torch

from . import _build

# kernel launches per operand dtype, counted where the kernel is launched
LAUNCHES = {'float32': 0, 'bfloat16': 0}

_ENTRY = {torch.float32: ('float32', 'dia_spmm_rows_f32'),
          torch.bfloat16: ('bfloat16', 'dia_spmm_rows_bf16')}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def dia_matmat_rows_plain(val, x, offsets):
    """Plain PyTorch DIA row apply, any device and dtype.  Accumulates in
    the promoted type of val and x (f32 for bf16 operands with f32
    values), adding the diagonals in order, and returns x's dtype."""
    m, n = x.shape
    y = torch.zeros((m, n), dtype=torch.promote_types(val.dtype, x.dtype),
                    device=x.device)
    for k, off in enumerate(offsets.tolist()):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            y[:, lo:hi] += val[k, lo:hi] * x[:, lo + off:hi + off]
    return y.to(x.dtype)


def _check(val, x, offsets):
    if not (val.device == x.device == offsets.device):
        raise ValueError('val, x and offsets must share a device (got %s, '
                         '%s, %s)' % (val.device, x.device, offsets.device))
    if x.dtype not in _ENTRY:
        raise TypeError('the DIA kernel takes f32 or bf16 operands, not %s'
                        % x.dtype)
    if val.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise TypeError('the DIA kernel takes f32 values and int32 offsets '
                        '(got %s, %s)' % (val.dtype, offsets.dtype))
    if (val.dim() != 2 or x.dim() != 2 or offsets.dim() != 1
            or val.shape[1] != x.shape[1]
            or offsets.shape[0] != val.shape[0]):
        raise ValueError('shape mismatch: val %s, x %s, offsets %s'
                         % (tuple(val.shape), tuple(x.shape),
                            tuple(offsets.shape)))
    if not (val.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError('the DIA kernel takes contiguous tensors')


def dia_matmat_rows(val, x, offsets):
    """(m, n) = DIA matrix applied to the (m, n) row block ``x``, in x's
    dtype.  CUDA tensors go through the kernel, CPU tensors through
    ``dia_matmat_rows_plain``."""
    if x.device.type == 'cpu':
        return dia_matmat_rows_plain(val, x, offsets)
    if x.device.type != 'cuda':
        raise ValueError('no DIA apply for device %s' % x.device)
    _check(val, x, offsets)
    y = torch.empty_like(x)
    m, n = x.shape
    if m == 0 or n == 0:
        return y
    key, entry = _ENTRY[x.dtype]
    fn = getattr(_build.library(), entry)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(val.data_ptr(), x.data_ptr(), y.data_ptr(), offsets.data_ptr(),
             val.shape[0], m, n, x.device.index, stream)
    if err != 0:
        raise RuntimeError('DIA kernel launch failed: CUDA error %d' % err)
    LAUNCHES[key] += 1
    return y
