"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file has a plain ``extern "C"`` interface, so one
``nvcc`` call compiles them all into one shared library (a few seconds,
where a source that includes PyTorch's headers takes minutes), and
``ctypes`` loads it. The build happens at first use, inside the call that
launches a kernel, never at import.

The library lands in ``build/nnueehcs_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so a stale build is never loaded.
nvcc writes to a temporary name that ``os.replace`` then moves into place:
concurrent processes may both build, but none loads a half-written file.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'nnueehcs_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
# C signatures of the exported launchers: (restype, argtypes)
SIGNATURES = {
    'nnueehcs_fused_ensemble_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int,
         ctypes.c_int, _P, ctypes.c_int, _P, _P, _P]),
}


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (``/usr/local/cuda``
    when that is unset), else raise."""
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        'nvcc not found on PATH or under CUDA_HOME '
        f'({cuda_home}); the CUDA kernels cannot be built')


def sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu'))


def _library_path() -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f'libnnueehcs_kernels-{digest.hexdigest()[:16]}.so'


class BuildInfo:
    """What the build did: library path, seconds spent in nvcc (0 when an
    existing build was reused) and nvcc's ``-Xptxas -v`` report."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


def build() -> BuildInfo:
    """Compile every ``csrc/*.cu`` file in one nvcc call, unless the
    library for these sources already exists."""
    path = _library_path()
    log_path = path.with_suffix('.log')
    if path.is_file():
        log = log_path.read_text() if log_path.is_file() else ''
        return BuildInfo(path, 0.0, log)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix='.tmp-', suffix='.so')
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, *map(str, sources())]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n'
                f'{proc.stdout}{proc.stderr}')
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        log_path.write_text(log)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(path, seconds, log)


@functools.lru_cache(maxsize=None)
def _load() -> tuple[ctypes.CDLL, BuildInfo]:
    info = build()
    lib = ctypes.CDLL(str(info.path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib, info


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return _load()[0]


def build_info() -> BuildInfo:
    """How the loaded library was built (builds it if needed)."""
    return _load()[1]
