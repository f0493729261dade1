"""Build and load the port's native (C++) data-path library
(vitax/_native/__init__.py).

``decode.cc`` beside this file compiles at first use, with g++ and libjpeg,
into a shared library under the gitignored ``vitax_torch/_build/``, named
by a hash of the source and the flags, so an edited source never loads a
stale library. The flags are the JAX package's, so both libraries resample
and round alike. The compiler writes a temporary file that ``os.replace``
moves into place, so processes that build at once (test workers) never
load a half-written library. Nothing compiles at import.

Where g++, libjpeg or its header is missing, ``load()`` returns None, says
why once (the compiler's stderr on a failed build) and ``unavailable_reason()``
keeps it; the datasets then decode through PIL. ``python -m
vitax_torch._native`` builds it ahead of time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "_native", "decode.cc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# -march=x86-64-v2, not native: a library built on a newer host must not
# fault on an older one; non-x86 hosts take the compiler's default.
MARCH = ("-march=x86-64-v2",) if os.uname().machine in ("x86_64", "amd64") else ()
GXX_FLAGS = ("-O3", *MARCH, "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-ljpeg", "-pthread")
_PROBE = b"#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason = ""                      # why the library is unavailable, once load() failed


def missing_toolchain() -> str:
    """Why the library cannot be built here ("" when g++ finds jpeglib.h):
    no g++ on PATH, or no libjpeg header in its include path."""
    if shutil.which("g++") is None:
        return "no g++ on PATH"
    r = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull], input=_PROBE,
                       capture_output=True, timeout=60)
    if r.returncode != 0:
        return "g++ finds no jpeglib.h (libjpeg's development header is not installed)"
    return ""


def lib_path() -> str:
    """The library's path, named by a hash of the flags and the source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvitax_torch_data_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile decode.cc unless its library exists; returns the path.
    Raises RuntimeError with the compiler's stderr when g++ fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp, *GXX_LIBS],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC} (rc {r.returncode}):\n{r.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _prototype(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_int_p = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    i32_p, u8_p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "vitax_jpeg_size": [ctypes.c_char_p, c_int_p, c_int_p],
        "vitax_process_file": [ctypes.c_char_p] + [c_int] * 9 + [ctypes.c_void_p],
        "vitax_process_batch": [ctypes.POINTER(ctypes.c_char_p), c_int, i32_p, c_int, c_int, c_int,
                                ctypes.c_void_p, u8_p, c_int],
        "vitax_jpeg_size_mem": [ctypes.c_char_p, c_int, c_int_p, c_int_p],
        "vitax_process_mem": [ctypes.c_char_p] + [c_int] * 10 + [ctypes.c_void_p],
        "vitax_process_batch_mem": [ctypes.POINTER(ctypes.c_char_p), i32_p, c_int, i32_p, c_int, c_int,
                                    c_int, ctypes.c_void_p, u8_p, c_int],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at first use; None (and the reason
    printed once) when it cannot be built or loaded."""
    global _lib, _reason
    if _lib is not None or _reason:
        return _lib
    with _lock:
        if _lib is not None or _reason:
            return _lib
        try:
            _lib = _prototype(ctypes.CDLL(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _reason = f"{type(e).__name__}: {e}"
            print(f"vitax_torch native data path unavailable, datasets decode through PIL: {_reason}",
                  file=sys.stderr, flush=True)
    return _lib


def available() -> bool:
    return load() is not None


def unavailable_reason() -> str:
    """Why load() returned None ("" when the library loaded or was never asked for)."""
    return _reason
