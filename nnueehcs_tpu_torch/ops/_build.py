"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file has a plain ``extern "C"`` interface (the device
code they share is in ``csrc/*.cuh``; the bf16 forms include ``cuda_bf16.h``
for its conversion intrinsics only), so nvcc compiles each in a few
seconds (a source that includes PyTorch's headers takes minutes). One nvcc
process per source runs at the same time, a last nvcc call links the
objects into one shared library, and ``ctypes`` loads it. The build happens
at first use, inside the call that launches a kernel, never at import.

The library lands in ``build/nnueehcs_tpu_torch/`` at the repository root,
named by a hash of the sources, headers and flags, so a stale build is
never loaded.
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
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')
LINK_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-shared')

_P = ctypes.c_void_p
# C signatures of the exported launchers: (restype, argtypes)
SIGNATURES = {
    'nnueehcs_fused_ensemble_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int,
         ctypes.c_int, _P, ctypes.c_int, _P, _P, _P]),
    'nnueehcs_fused_mc_dropout_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         _P, _P, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, _P, _P, _P]),
    'nnueehcs_fused_anchored_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         ctypes.c_int, ctypes.c_int, _P, _P, _P]),
    'nnueehcs_fused_ensemble_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int,
         ctypes.c_int, _P, ctypes.c_int, _P, _P, _P]),
    'nnueehcs_fused_mc_dropout_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         _P, _P, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, _P, _P, _P]),
    'nnueehcs_fused_anchored_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         ctypes.c_int, ctypes.c_int, _P, _P, _P]),
    'nnueehcs_packed_forward_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P, _P,
         ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P, _P]),
    'nnueehcs_kde_logpdf_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int,
         ctypes.c_double, _P, _P]),
    'nnueehcs_fused_train_f32': (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float)]
        + [_P] * 15),
    'nnueehcs_fused_train_bf16': (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float)]
        + [_P] * 15),
    'nnueehcs_fused_train_scratch_floats': (
        ctypes.c_longlong, [ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    'nnueehcs_ablate_chain_f32': (
        ctypes.c_int,
        [ctypes.c_int] * 4
        + [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P, _P,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, _P, _P, _P]),
    'nnueehcs_ablate_train_f32': (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float)]
        + [_P] * 13
        + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P,
           _P, _P]),
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
    digest = hashlib.sha256(' '.join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob('*.cuh')]):
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


def _run_all(cmds):
    """Run the commands at the same time; raise with the output of the
    first that fails. Returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                               f'{" ".join(cmd)}\n{out}')
    return ''.join(outputs)


def build() -> BuildInfo:
    """Compile every ``csrc/*.cu`` file, one nvcc process each, all at
    once, and link them into one library, unless the library for these
    sources already exists."""
    path = _library_path()
    log_path = path.with_suffix('.log')
    if path.is_file():
        log = log_path.read_text() if log_path.is_file() else ''
        return BuildInfo(path, 0.0, log)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix='.tmp-') as tmp:
        objects = [os.path.join(tmp, src.stem + '.o') for src in sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', obj, str(src)]
                        for src, obj in zip(sources(), objects)])
        lib = os.path.join(tmp, path.name)
        log += _run_all([[nvcc, *LINK_FLAGS, '-o', lib, *objects]])
        seconds = time.perf_counter() - start
        log_path.write_text(log)
        os.replace(lib, path)
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
