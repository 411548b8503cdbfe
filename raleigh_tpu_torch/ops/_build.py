"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``raleigh_tpu_torch/csrc/*.cu`` for
``sm_90a`` into a shared library of its own with a plain C interface (no
PyTorch headers, so a build takes seconds), all sources at once in
parallel, and ``ctypes`` loads them.  The libraries are kept under
``raleigh_tpu_torch/_build/`` (ignored by git), each keyed by a hash of
its source and the flags, so an edit to a source rebuilds it.

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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# C entry points by source, with their argument types: every pointer (and
# the stream) as c_void_p, sizes as 64-bit ints, the device ordinal as int
_DIA_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])
_BSR_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])
_SIGNATURES = {
    'dia_spmm': {'dia_spmm_rows_f32': _DIA_ARGS,
                 'dia_spmm_rows_bf16': _DIA_ARGS},
    'bsr_spmm': {'bsr_spmm_rows_f32_f32': _BSR_ARGS,
                 'bsr_spmm_rows_f32_bf16': _BSR_ARGS,
                 'bsr_spmm_rows_bf16_f32': _BSR_ARGS,
                 'bsr_spmm_rows_bf16_bf16': _BSR_ARGS},
    'stream_scale': {'stream_scale_f32': [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]},
}

_loaded = {}


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
    logs = []
    for src, out in targets.items():
        cdll = ctypes.CDLL(str(out))
        for name, args in _SIGNATURES.get(src.stem, {}).items():
            fn = getattr(cdll, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            setattr(lib, name, fn)
        log = out.with_suffix('.log')
        logs.append(log.read_text() if log.exists() else '')
    _loaded['lib'] = lib
    _loaded['report'] = {'path': str(BUILD_DIR), 'seconds': seconds,
                         'log': ''.join(logs)}
    return lib


def build_report():
    """{'path', 'seconds', 'log'} of the loaded kernels: the build
    directory, the wall time of the parallel ``nvcc`` runs (0.0 when every
    build was reused) and nvcc's output (the ``-Xptxas -v`` register and
    spill lines)."""
    library()
    return dict(_loaded['report'])
