"""Build `csrc/*.cu` with nvcc (and the host code `csrc/*.cpp` with the C++
compiler) at first use and bind them with ctypes.

Each source compiles on its own into `offsetguided_tpu_torch/_build/` (listed
in `.gitignore`) as a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu
    c++ -std=c++17 -O3 -shared -fPIC -ffp-contract=off \
         -o _build/lib<name>-<hash>.so csrc/<name>.cpp

The file name carries a hash of the source, of every `csrc/*.cuh` header it
includes (`#include "<name>.cuh"`, followed into headers) and of the
compiler flags, so an edit to any of them rebuilds.
`build_all()` starts one nvcc per source at once and waits for all of them.
Every C entry point returns the `cudaGetLastError()` of its launches; the
callers raise on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / 'csrc'
BUILD = PKG / '_build'
SOURCES = ('peaks', 'grouping', 'topk', 'nms_topk')
HOST_SOURCES = ('host_warp', 'codec')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# no contraction: only the source's explicit fmaf calls fuse
CXX_FLAGS = ['-std=c++17', '-O3', '-shared', '-fPIC', '-ffp-contract=off']

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report of each build of this process, for `chip_smoke.py`
build_logs: Dict[str, str] = {}

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float
c_longlong = ctypes.c_longlong

SIGNATURES = {
    'peaks': {
        'og_peaks_tiles': ([c_int, c_int], c_int),
        'og_peaks_smem_bytes': ([c_int], c_longlong),
        'og_peaks_topk': ([c_ptr, c_int, c_int, c_int, c_int, c_ptr, c_ptr,
                           c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr], c_int),
    },
    'grouping': {
        'og_group_smem_bytes': ([c_int, c_int, c_int, c_int],
                                ctypes.c_longlong),
        'og_group_skeletons': ([c_ptr, c_ptr, c_int, c_int, c_int, c_int,
                                c_int, c_int, c_int, c_int, c_int, c_float,
                                c_float, c_ptr, c_ptr, c_ptr, c_ptr], c_int),
    },
    'topk': {
        'og_topk_tiles': ([c_int], c_int),
        'og_topk_smem_bytes': ([c_int], c_longlong),
        'og_topk': ([c_ptr, c_int, c_int, c_int, c_ptr, c_ptr, c_ptr, c_ptr],
                    c_int),
    },
    'nms_topk': {
        'og_nms_topk_smem_bytes': ([c_int, c_int, c_int], c_longlong),
        'og_nms_topk': ([c_ptr, c_int, c_int, c_int, c_int, c_ptr, c_ptr,
                         c_ptr], c_int),
    },
    'host_warp': {
        'og_warp_affine_u8': ([c_ptr, c_int, c_int, c_int, c_ptr, c_ptr,
                               c_ptr, c_int, c_int], c_int),
        'og_resize_cubic_u8': ([c_ptr, c_int, c_int, c_int, c_ptr, c_int,
                                c_int], c_int),
    },
    'codec': {
        'og_jpeg_info': ([c_ptr, ctypes.c_long, c_ptr], c_int),
        'og_jpeg_decode': ([c_ptr, ctypes.c_long, c_ptr, c_int, c_int],
                           c_int),
        'og_jpeg_encode': ([c_ptr, c_int, c_int, c_int, c_int, c_int, c_int,
                            c_int, c_ptr, ctypes.c_long, c_ptr], c_int),
        'og_png_unfilter': ([c_ptr, c_int, c_int, c_int, c_ptr], c_int),
    },
}
# csrc/topk_select.cuh's shared-memory arithmetic, for the selection
# kernels' wrappers: the most a block can have (Hopper's 227 KB opt-in),
# og::SelectShared's bytes, and og::win_keys.
MAX_SMEM = 232448
SELECT_SHARED_BYTES = 1056


def win_keys(k: int) -> int:
    """Keys of scratch the selection of k keys needs: k for the warp sort
    (k <= 32), else the next power of two >= max(k, 64)."""
    p = 64
    while p < k:
        p <<= 1
    return k if k <= 32 else p


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([A-Za-z0-9_]+\.cuh)"', re.M)


def nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                           'machine with the CUDA toolkit')
    return path


def cxx() -> str:
    path = shutil.which('c++') or shutil.which('g++')
    if path is None:
        raise RuntimeError('no C++ compiler (c++ or g++) found: the host '
                           'code in csrc/*.cpp builds with one')
    return path


def _host(name: str) -> bool:
    return name in HOST_SOURCES


def _sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` (or `.cpp`) and the `csrc/*.cuh` headers it
    includes, in inclusion order."""
    files, todo = [], [CSRC / (f'{name}.cpp' if _host(name)
                               else f'{name}.cu')]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(f.read_bytes())]
    return files


def _target(name: str) -> Path:
    h = hashlib.sha256(' '.join(CXX_FLAGS if _host(name)
                                else NVCC_FLAGS).encode())
    for f in _sources(name):
        h.update(f.name.encode() + b'\0' + f.read_bytes())
    return BUILD / f'lib{name}-{h.hexdigest()[:12]}.so'


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    src = _sources(name)[0]
    cmd = ([cxx(), *CXX_FLAGS] if _host(name) else [nvcc(), *NVCC_FLAGS])
    cmd += ['-o', str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f'the build of {_sources(name)[0].name} '
                           f'failed:\n{log}')
    os.replace(tmp, out)


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (args, res) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = res
    return lib


def build_all(names: List[str] = SOURCES) -> None:
    """Build every missing library in parallel, one nvcc per source."""
    with _lock:
        jobs = {n: _start(n) for n in names if n not in _libs}
        for n, job in jobs.items():
            _finish(n, job)
            _libs[n] = _bind(n)


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all([name])
    return _libs[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f'{what}: CUDA error {code}')
