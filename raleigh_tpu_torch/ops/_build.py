"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``raleigh_tpu_torch/csrc/*.cu`` for
``sm_90a`` into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), and ``ctypes`` loads it.  The library
is kept under ``raleigh_tpu_torch/_build/`` (ignored by git), keyed by a
hash of the sources and the flags, so an edit to a source rebuilds it.

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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# C entry points and their argument types: every pointer (and the stream)
# as c_void_p, sizes as 64-bit ints, the device ordinal as int
_DIA_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])
_SIGNATURES = {
    'dia_spmm_rows_f32': _DIA_ARGS,
    'dia_spmm_rows_bf16': _DIA_ARGS,
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
    if not srcs:
        raise RuntimeError('no CUDA sources under %s' % CSRC)
    return srcs


def _key(srcs):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library():
    """The loaded kernel library, built first if no build of the current
    sources exists.  Raises if ``nvcc`` fails."""
    if 'lib' in _loaded:
        return _loaded['lib']
    srcs = _sources()
    out = BUILD_DIR / ('libraleigh_kernels_%s.so' % _key(srcs))
    log = out.with_suffix('.log')
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name('%s.%d.tmp' % (out.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed (%d):\n%s\n%s' % (
                proc.returncode, ' '.join(cmd), proc.stderr))
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)        # atomic against a concurrent build
    lib = ctypes.CDLL(str(out))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    _loaded['lib'] = lib
    _loaded['report'] = {'path': str(out), 'seconds': seconds,
                         'log': log.read_text() if log.exists() else ''}
    return lib


def build_report():
    """{'path', 'seconds', 'log'} of the loaded library: ``seconds`` is
    0.0 when an existing build was reused, ``log`` holds nvcc's output
    (the ``-Xptxas -v`` register and spill lines)."""
    library()
    return dict(_loaded['report'])
