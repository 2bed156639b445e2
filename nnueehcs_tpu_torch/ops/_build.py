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
         ctypes.c_int, _P, ctypes.c_int, _P, _P,
         ctypes.POINTER(ctypes.c_int), _P]),
    'nnueehcs_fused_ensemble_f32_clusters': (
        ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]),
    'nnueehcs_fused_mc_dropout_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         _P, _P, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, _P,
         ctypes.c_uint32, ctypes.c_int, _P, _P, ctypes.POINTER(ctypes.c_int),
         _P]),
    'nnueehcs_fused_mc_dropout_f32_clusters': (
        ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]),
    'nnueehcs_fused_anchored_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         ctypes.c_int, ctypes.c_int, _P, _P, ctypes.POINTER(ctypes.c_int),
         _P]),
    'nnueehcs_fused_anchored_f32_clusters': (
        ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]),
    'nnueehcs_fused_ensemble_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int,
         ctypes.c_int, _P, ctypes.c_int, _P, _P,
         ctypes.POINTER(ctypes.c_int), _P]),
    'nnueehcs_fused_ensemble_bf16_clusters': (
        ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]),
    'nnueehcs_fused_mc_dropout_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         _P, _P, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, _P,
         ctypes.c_uint32, ctypes.c_int, _P, _P, ctypes.POINTER(ctypes.c_int),
         _P]),
    'nnueehcs_fused_anchored_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P,
         ctypes.c_int, ctypes.c_int, _P, _P, ctypes.POINTER(ctypes.c_int),
         _P]),
    'nnueehcs_packed_forward_bf16': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P, _P,
         ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
         ctypes.POINTER(ctypes.c_int), _P]),
    'nnueehcs_packed_forward_bf16_clusters': (
        ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]),
    'nnueehcs_kde_logpdf_f32': (
        ctypes.c_int,
        [_P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int,
         ctypes.c_double, _P, _P]),
    'nnueehcs_fused_train_f32': (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
         ctypes.POINTER(ctypes.c_longlong)] + [_P] * 17),
    'nnueehcs_fused_train_bf16': (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
         ctypes.POINTER(ctypes.c_longlong)] + [_P] * 17),
    'nnueehcs_ablate_chain_f32': (
        ctypes.c_int,
        [ctypes.c_int] * 3
        + [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P, _P,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
           ctypes.c_int, _P, _P, _P]),
    'nnueehcs_ablate_forward_f32': (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         _P, ctypes.c_int, ctypes.c_int, _P, _P,
         ctypes.POINTER(ctypes.c_int), _P]),
    'nnueehcs_ablate_forward_f32_clusters': (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    'nnueehcs_ablate_train_f32': (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
         ctypes.POINTER(ctypes.c_longlong)] + [_P] * 13
        + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P,
           _P, _P, _P]),
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
    """The ``csrc/*.cu`` files."""
    return sorted(CSRC.glob('*.cu'))


def _library_path(flags=()) -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS + LINK_FLAGS
                                     + tuple(flags)).encode())
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


def build(flags=()) -> BuildInfo:
    """Compile every ``csrc/*.cu`` file, one nvcc process each, all at
    once, with ``flags`` added (a ``-D`` define), and link them into one
    library, unless the library for these sources and flags already
    exists."""
    path = _library_path(flags)
    log_path = path.with_suffix('.log')
    if path.is_file():
        log = log_path.read_text() if log_path.is_file() else ''
        return BuildInfo(path, 0.0, log)
    nvcc = find_nvcc()
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix='.tmp-') as tmp:
        objects = [os.path.join(tmp, src.stem + '.o') for src in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, *flags, '-c', '-o', obj,
                         str(src)] for src, obj in zip(srcs, objects)])
        lib = os.path.join(tmp, path.name)
        log += _run_all([[nvcc, *LINK_FLAGS, '-o', lib, *objects]])
        seconds = time.perf_counter() - start
        log_path.write_text(log)
        os.replace(lib, path)
    return BuildInfo(path, seconds, log)


def load(flags=()) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load the library compiled with ``flags``, its
    exported launchers typed: :func:`library`'s, or with a ``-D`` define
    an instrumented one beside it (:func:`stamped_library`)."""
    info = build(flags)
    lib = ctypes.CDLL(str(info.path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib, info


@functools.lru_cache(maxsize=None)
def _load() -> tuple[ctypes.CDLL, BuildInfo]:
    return load()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return _load()[0]


def build_info() -> BuildInfo:
    """How the loaded library was built (builds it if needed)."""
    return _load()[1]


# the phase stamps (csrc/stamps.cuh): a build with this define, the
# translation units whose kernels stamp, and the words each one's reader
# gives (kSlots clock sums, then the stamped spans' wall ns)
STAMPS_FLAG = '-DNNUEEHCS_STAMPS'
STAMPED_UNITS = ('fused_train', 'fused_train_bf16', 'fused_mc_dropout',
                 'fused_anchored', 'fused_ensemble', 'kde')
STAMP_SLOTS = 1024


def stamped_library() -> ctypes.CDLL:
    """The kernel library built with :data:`STAMPS_FLAG` beside the
    package's own (for the phase tools under ``tools/``)."""
    lib, _ = load((STAMPS_FLAG,))
    for unit in STAMPED_UNITS:
        fn = getattr(lib, f'nnueehcs_stamps_{unit}')
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
        fn = getattr(lib, f'nnueehcs_stamps_block_{unit}')
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
    return lib


def stamp_block(lib: ctypes.CDLL, unit: str, block: int) -> None:
    """Stamp block ``block`` of translation unit ``unit``'s kernels (block
    0 until this is called) from the next launch on."""
    err = getattr(lib, f'nnueehcs_stamps_block_{unit}')(block)
    if err:
        raise RuntimeError(f'choosing the {unit} stamp block: CUDA error '
                           f'{err}')


def read_stamps(lib: ctypes.CDLL, unit: str) -> tuple[list[int], int]:
    """Read and clear the stamps of translation unit ``unit`` of a
    :func:`stamped_library`: the clock cycles of each phase slot and the
    stamped spans' wall time in ns, summed since the last read."""
    buf = (ctypes.c_ulonglong * (STAMP_SLOTS + 1))()
    err = getattr(lib, f'nnueehcs_stamps_{unit}')(ctypes.addressof(buf))
    if err:
        raise RuntimeError(f'reading the {unit} stamps: CUDA error {err}')
    words = list(buf)
    return words[:STAMP_SLOTS], words[STAMP_SLOTS]
