"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``raleigh_tpu_torch/csrc/*.cu`` for
``sm_90a`` into a shared library of its own with a plain C interface (no
PyTorch headers, so a build takes seconds), all sources at once in
parallel, and ``ctypes`` loads them.  The libraries are kept under
``raleigh_tpu_torch/_build/`` (ignored by git), each keyed by a hash of
its source, the shared headers (``csrc/*.cuh``) and the flags, so an edit
to a source or a header rebuilds it.

Nothing here runs at import: the CPU-only test environment has no
``nvcc`` and imports every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# bytes of shared memory one thread block can use on an H100 (227 KB); the
# wrappers of the kernels that size their shared memory at launch check
# against it, on the CPU too
SMEM_PER_BLOCK = 232448

# C entry points by source, with their argument types: every pointer (and
# the stream) as c_void_p, sizes as 64-bit ints, the device ordinal as int
_DIA_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])
_BSR_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])
# val, x, y, host offsets; noff, m, n, tile, chunk; rows
# per block, device; stream
_CLUSTER_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# and their launch plans: host offsets; noff, m, n, tile, chunk; rows per
# block, bulk-copy branch, device; host plan
_PLAN_ARGS = ([ctypes.c_void_p] + [ctypes.c_int64] * 5
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# val, x_ext, y, offsets; noff, m, n, row stride of x_ext, halo_lo; device;
# stream
_EXT_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5
             + [ctypes.c_int, ctypes.c_void_p])
# a host parameter block and its size in bytes; device; stream
_TABLE_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
               ctypes.c_void_p]
# x, y, a, count; device; stream
_STREAM_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
# x, y, a, count, tile, depth, chunk counter, device, stream
_DRAWN_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
               ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_void_p]
# idx, val, x, y; n, K, m, row stride of x, y's row and column strides;
# device; stream
_ELL_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
             + [ctypes.c_int, ctypes.c_void_p])
# idx, val, d, d_next, r, y; c1, c2; n, K, m; first, last, device; stream
_ELL_STEP_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_double] * 2
                  + [ctypes.c_int64] * 3 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
# instantiation, m, device, host int64[4]
_ELL_OCCUPANCY_ARGS = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
# a, b, partial tiles, g; ma, mb, n; own (B is A), device; stream
_GRAM_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
              + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# ma, mb, own, device, host int64[4]
_GRAM_OCCUPANCY_ARGS = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
_ELL_PAIRS = (('f32', 'f32'), ('f32', 'bf16'), ('f32', 'f64'),
              ('f64', 'f64'))
# (tile, operand) types of the BSR kernel's entries
_BSR_PAIRS = [(b, x) for b in ('f32', 'bf16') for x in ('f32', 'bf16')] \
    + [('f32', 'f64'), ('f64', 'f64')]
_SIGNATURES = {
    'dia_spmm': {'dia_spmm_rows_f32': _DIA_ARGS,
                 'dia_spmm_rows_bf16': _DIA_ARGS,
                 'dia_spmm_rows_f64_val32': _DIA_ARGS,
                 'dia_spmm_rows_f64_val64': _DIA_ARGS,
                 'dia_spmm_rows_c128_val32': _DIA_ARGS,
                 'dia_spmm_rows_c128_val64': _DIA_ARGS,
                 'dia_spmm_rows_c128_val128': _DIA_ARGS},
    'dia_spmm_ext': {'dia_spmm_rows_ext_f32': _EXT_ARGS,
                     'dia_spmm_rows_ext_bf16': _EXT_ARGS,
                     'dia_spmm_rows_ext_f64_val32': _EXT_ARGS,
                     'dia_spmm_rows_ext_f64_val64': _EXT_ARGS,
                     'dia_spmm_mesh_f32': _TABLE_ARGS,
                     'dia_spmm_mesh_bf16': _TABLE_ARGS,
                     'dia_spmm_mesh_f64_val32': _TABLE_ARGS,
                     'dia_spmm_mesh_f64_val64': _TABLE_ARGS},
    'copy_lanes': {'copy_lanes_many': _TABLE_ARGS},
    'dia_spmm_slide': {'dia_spmm_rows_slide_f32': _CLUSTER_ARGS,
                       'dia_spmm_rows_slide_plan': _PLAN_ARGS},
    'dia_spmm_tiles': {'dia_spmm_rows_tiles_f32': _CLUSTER_ARGS,
                       'dia_spmm_rows_tiles_plan': _PLAN_ARGS},
    'bsr_spmm': {'bsr_spmm_rows_%s_%s' % pair: _BSR_ARGS
                 for pair in _BSR_PAIRS},
    'ell_spmm': dict({'ell_spmm_%s_%s' % pair: _ELL_ARGS
                      for pair in _ELL_PAIRS},
                     ell_spmm_occupancy=_ELL_OCCUPANCY_ARGS,
                     **{'ell_step_%s_%s' % pair: _ELL_STEP_ARGS
                        for pair in _ELL_PAIRS if pair[1] != 'bf16'}),
    'gram': {'gram_f32': _GRAM_ARGS,
             'gram_f32_occupancy': _GRAM_OCCUPANCY_ARGS},
    'stream_scale': {'stream_scale_f32': _STREAM_ARGS},
    'stream_probes': {
        # x, y, a, count, chunk, device, stream
        'stream_scale_tiled_f32': [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
        'stream_scale_pipelined_f32': _DRAWN_ARGS},
}

_loaded = {}


def current_stream(index):
    """The raw ``cudaStream_t`` (an int) of the current stream of CUDA
    device ``index``, the stream every kernel launches on, read as torch's
    own generated code reads it: ``torch._C._cuda_getCurrentRawStream``
    builds no ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(index)


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which('nvcc')
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, 'bin', 'nvcc')
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put it on '
                           'PATH): the CUDA kernels cannot be built')
    return found


def _sources():
    srcs = sorted(CSRC.glob('*.cu'))
    missing = set(_SIGNATURES) - {s.stem for s in srcs}
    if missing:
        raise RuntimeError('CUDA sources missing under %s: %s'
                           % (CSRC, sorted(missing)))
    return srcs


def _target(src):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):   # the headers sources share
        h.update(header.read_bytes())
    return BUILD_DIR / ('lib%s_%s.so' % (src.stem, h.hexdigest()[:16]))


def library():
    """The loaded kernels, one attribute per C entry point; sources with
    no build of their current text are built first, all at once.  Raises
    if ``nvcc`` fails."""
    if 'lib' in _loaded:
        return _loaded['lib']
    targets = {src: _target(src) for src in _sources()}
    procs = {}
    t0 = time.perf_counter()
    for src, out in targets.items():
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name('%s.%d.tmp' % (out.name, os.getpid()))
            cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
            procs[src] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    failed = []
    for src, (cmd, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append('nvcc failed (%d):\n%s\n%s' % (
                proc.returncode, ' '.join(cmd), stderr))
            continue
        targets[src].with_suffix('.log').write_text(stdout + stderr)
        os.replace(tmp, targets[src])   # atomic against a concurrent build
    if failed:
        raise RuntimeError('\n'.join(failed))
    seconds = time.perf_counter() - t0 if procs else 0.0
    lib = SimpleNamespace()
    logs = {}
    for src, out in targets.items():
        cdll = ctypes.CDLL(str(out))
        for name, args in _SIGNATURES.get(src.stem, {}).items():
            fn = getattr(cdll, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            setattr(lib, name, fn)
        log = out.with_suffix('.log')
        logs[src.stem] = log.read_text() if log.exists() else ''
    _loaded['lib'] = lib
    _loaded['report'] = {'path': str(BUILD_DIR), 'seconds': seconds,
                         'log': ''.join(logs.values()), 'logs': logs}
    return lib


def build_report():
    """{'path', 'seconds', 'log', 'logs'} of the loaded kernels: the build
    directory, the wall time of the parallel ``nvcc`` runs (0.0 when every
    build was reused) and nvcc's output (the ``-Xptxas -v`` register and
    spill lines), all of it and by source name."""
    library()
    return dict(_loaded['report'])
