"""Native (C++) parser for delimited numeric tables.

Counterpart of ``nnueehcs_tpu/native/__init__.py``. ``load_delimited``
parses a numeric table with the multithreaded mmap parser of
``fastload.cpp`` (a copy of the JAX package's), bound through ``ctypes``.
``g++`` builds the shared library at first use into
``build/nnueehcs_tpu_torch/`` at the repository root, named by a hash of
the source and flags, so a stale build is never loaded; it writes to a
temporary name that ``os.replace`` moves into place. The loader returns
None when the library cannot be built or the file is not a clean numeric
table, and the caller then parses the file another way: the native path is
an optimisation, never a requirement.

``load_delimited.native_reads`` counts the files the native parser read.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / 'fastload.cpp'
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

_DELIM_MAP = {r'\s+': 0, ' ': 0, '\t': 0, ',': ord(','), ';': ord(';'),
              '|': ord('|')}


def _library_path() -> Path:
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f'libfastload-{digest.hexdigest()[:16]}.so'


def build() -> Optional[Path]:
    """Compile ``fastload.cpp`` unless this source's library exists;
    None when ``g++`` is missing or fails."""
    path = _library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix='.tmp-') as tmp:
        lib = os.path.join(tmp, path.name)
        try:
            subprocess.run(['g++', *CXX_FLAGS, '-o', lib, str(SRC),
                            '-lpthread'], check=True, capture_output=True,
                           timeout=120)
        except (subprocess.SubprocessError, OSError):
            return None
        os.replace(lib, path)
    return path


@functools.lru_cache(maxsize=None)
def library() -> Optional[ctypes.CDLL]:
    """The loaded parser, built on first call; None when it cannot be
    built."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.fl_parse.restype = ctypes.POINTER(ctypes.c_double)
    lib.fl_parse.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
                             ctypes.POINTER(ctypes.c_long),
                             ctypes.POINTER(ctypes.c_long)]
    lib.fl_free.restype = None
    lib.fl_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    return lib


def load_delimited(path, delimiter: str,
                   skip_rows: int = 0) -> Optional[np.ndarray]:
    """Parse a numeric delimited file into a (rows, cols) float64 array.
    Returns None when the native path is unavailable or the file is not a
    clean numeric table (the caller parses it another way)."""
    if not isinstance(path, str) or delimiter not in _DELIM_MAP:
        return None
    lib = library()
    if lib is None:
        return None
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    ptr = lib.fl_parse(path.encode(), _DELIM_MAP[delimiter], skip_rows,
                       ctypes.byref(rows), ctypes.byref(cols))
    if not ptr:
        return None
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    finally:
        lib.fl_free(ptr)
    load_delimited.native_reads += 1
    return arr.reshape(rows.value, cols.value)


load_delimited.native_reads = 0
