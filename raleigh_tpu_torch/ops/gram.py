"""The Gram of two row blocks, G = A Bᵀ, contracted over the vector
dimension: the device LOBPCG's Grams (``core/device_solver.py::_gram``).

``gram`` takes the hand-written kernel (``csrc/gram.cu``) for what it was
built for, real f32 (ma, n) and (mb, n) CUDA blocks at the LOBPCG's widths
(``WIDTHS``) with n at or past ``GRAM_MIN_N``, and ``torch.matmul`` for
everything else: CPU, f64 and complex blocks, other widths, short
contractions and empty operands.  ``gram_kernel`` is the kernel's wrapper:
the plain version for CPU tensors, a launch or an error for CUDA tensors.

Nothing here builds or loads the kernels at import."""

import ctypes

import torch

from . import _build

# (ma, mb) the kernel is instantiated at: the device LOBPCG's block m = 16
# and its Rayleigh-Ritz basis of 3m = 48 rows
WIDTHS = ((16, 16), (48, 48))
# the shortest contraction the kernel takes; shorter Grams go to
# torch.matmul.  Device ms in CUDA graphs, in turns on an H100 80GB HBM3
# (700 W), kernel / torch.matmul, at (16, 16), a self-Gram and (48, 48):
# n = 16,384: 0.0055 / 0.0128, 0.0051 / 0.0128, 0.0127 / 0.0140;
# n = 8,192: 0.0054 / 0.0110, 0.0052 / 0.0111, 0.0127 / 0.0113;
# n = 2,048: 0.0054 / 0.0077, 0.0051 / 0.0077, 0.0127 / 0.0086.  The kernel
# wins every width at every n measured from 16,384 up (1.10x to 6.0x at
# n = 139,179 and 1,280,000), and the (48, 48) Gram loses below it.
GRAM_MIN_N = 16384

# kernel launches by (dtype, ma, mb, self-Gram), counted where the kernel
# is launched
GRAM_LAUNCHES = {('f32', ma, mb, own): 0 for ma, mb in WIDTHS
                 for own in (False, True)}
# Grams of two non-empty CUDA blocks that ``gram`` sent to torch.matmul:
# their total under 'device', and by (dtype, ma, mb) beside it
MATMUL_GRAMS = {'device': 0}
# the short names of the dtypes in the counters' keys
_DTYPES = {torch.float32: 'f32', torch.float64: 'f64',
           torch.complex64: 'c64', torch.complex128: 'c128'}
# partial tiles a launch may leave, by (ma, mb, self-Gram, device index)
_SLOTS = {}


def reset_launches():
    for counts in (GRAM_LAUNCHES, MATMUL_GRAMS):
        for key in counts:
            counts[key] = 0


def dtype_name(dtype):
    """The short name of ``dtype`` in the counters' keys ('f32', ...)."""
    return _DTYPES.get(dtype, str(dtype).replace('torch.', ''))


def takes_kernel(a, b):
    """True where the kernel computes ``a`` ``b``ᵀ: two plain contiguous
    real f32 tensors on one CUDA device, (ma, n) and (mb, n) at widths
    the kernel was built for, n at or past ``GRAM_MIN_N``."""
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.device.type == 'cuda' and a.device == b.device
            and a.dtype == b.dtype == torch.float32
            and a.dim() == b.dim() == 2
            and (a.shape[0], b.shape[0]) in WIDTHS
            and a.shape[1] == b.shape[1] >= GRAM_MIN_N
            and a.is_contiguous() and b.is_contiguous())


def gram(a, b):
    """The (ma, mb) Gram ``a.conj() @ b.T`` of row blocks ``a`` (ma, n)
    and ``b`` (mb, n): through the kernel where ``takes_kernel`` says so
    (a self-Gram when ``a is b``), else through ``torch.matmul``, counted
    in ``MATMUL_GRAMS`` when both blocks are non-empty CUDA tensors, in
    all and by (dtype, ma, mb)."""
    if takes_kernel(a, b):
        return gram_kernel(a, b)
    if a.device.type == 'cuda' and a.numel() and b.numel():
        MATMUL_GRAMS['device'] += 1
        key = (dtype_name(a.dtype), a.shape[0], b.shape[0])
        MATMUL_GRAMS[key] = MATMUL_GRAMS.get(key, 0) + 1
    return gram_plain(a, b)


def gram_plain(a, b):
    """The kernel's plain version: ``a.conj()`` times ``b``ᵀ."""
    return torch.matmul(a.conj(), b.transpose(0, 1))


def _check(a, b):
    """Raise on what the kernel does not take."""
    if a.device != b.device:
        raise ValueError('the blocks must share a device (got %s, %s)'
                         % (a.device, b.device))
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError('the Gram kernel takes real f32 blocks, not %s, %s'
                        % (a.dtype, b.dtype))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1] \
            or a.shape[1] < 1:
        raise ValueError('shape mismatch: %s, %s'
                         % (tuple(a.shape), tuple(b.shape)))
    if (a.shape[0], b.shape[0]) not in WIDTHS:
        raise ValueError('the Gram kernel is built for widths %s, not %s'
                         % (WIDTHS, (a.shape[0], b.shape[0])))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError('the Gram kernel takes contiguous blocks')
    if a.device.type != 'cuda':
        raise ValueError('no Gram kernel for device %s' % a.device)


def gram_kernel(a, b):
    """(ma, mb) = a bᵀ for (ma, n) and (mb, n) blocks: CPU tensors through
    ``gram_plain``, CUDA tensors through one launch of the kernel and one
    of its sum of partial tiles (both on the current stream, no
    synchronisation), counted in ``GRAM_LAUNCHES``; a CUDA tensor the
    kernel does not take raises.  ``a is b`` reads the block once."""
    if a.device.type == 'cpu':
        return gram_plain(a, b)
    _check(a, b)
    own = a is b
    ma, mb = a.shape[0], b.shape[0]
    index = a.get_device()
    slots = _slots(ma, mb, own, index)
    partial = torch.empty((slots, ma, mb), dtype=a.dtype, device=a.device)
    g = torch.empty((ma, mb), dtype=a.dtype, device=a.device)
    err = _build.library().gram_f32(
        a.data_ptr(), b.data_ptr(), partial.data_ptr(), g.data_ptr(), ma,
        mb, a.shape[1], int(own), index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError('Gram kernel launch failed (%d x %d, self %s): '
                           'CUDA error %d' % (ma, mb, own, err))
    GRAM_LAUNCHES[('f32', ma, mb, own)] += 1
    return g


def occupancy(ma, mb, own, device=None):
    """{'registers', 'blocks_per_sm', 'slots', 'local_bytes'} of the
    kernel's instantiation (ma, mb, self-Gram) as the card's runtime
    reports them; ``slots`` is the partial tiles a launch may leave.
    Nothing is launched."""
    device = torch.device('cuda') if device is None else torch.device(device)
    if device.type != 'cuda':
        raise ValueError('Gram occupancy needs a CUDA device, not %s'
                         % device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    out = (ctypes.c_int64 * 4)()
    err = _build.library().gram_f32_occupancy(ma, mb, int(own), index,
                                               ctypes.addressof(out))
    if err != 0:
        raise RuntimeError('gram_f32_occupancy failed: CUDA error %d' % err)
    return dict(zip(('registers', 'blocks_per_sm', 'slots', 'local_bytes'),
                    out))


def _slots(ma, mb, own, index):
    key = (ma, mb, own, index)
    if key not in _SLOTS:
        _SLOTS[key] = occupancy(ma, mb, own, index)['slots']
    return _SLOTS[key]
