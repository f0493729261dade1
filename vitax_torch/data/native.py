"""numpy-facing wrappers over the native (C++) data-path library
(vitax/data/native.py), between the datasets and ``vitax_torch._native``.

Each call decodes a JPEG with libjpeg, resamples it with the PIL-parity
bicubic filter, crops, flips and writes (S, S, 3) uint8, or float32
normalized with ImageNet's mean and std. The batch calls spread a whole
batch over a C++ std::thread pool in one call. ctypes releases the GIL for
the length of every call, so the loader's other threads and the train
loop keep running while a batch decodes.

Two sources: files (``jpeg_size``, ``process_file``, ``process_batch``)
and bytes in memory (``jpeg_size_bytes``, ``process_bytes``,
``process_batch_bytes``: shard records and /predict bodies). params are
(mode, left, top, cw, ch, flip) from a transform's ``native_params``. Every
call returns None, or (None, every index) for a batch, when the library
is unavailable, and the caller decodes through PIL.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vitax_torch import _native

_JPEG_EXT = (".jpg", ".jpeg", ".jpe", ".jfif")
_JPEG_MAGIC = b"\xff\xd8\xff"  # SOI marker + first segment byte


def available() -> bool:
    return _native.available()


def is_jpeg_path(path: str) -> bool:
    return path.lower().endswith(_JPEG_EXT)


def is_jpeg_bytes(data: bytes) -> bool:
    """Content sniff: JPEG streams start with the SOI marker (shard records
    and /predict bodies carry no file name)."""
    return data[:3] == _JPEG_MAGIC


def _out(shape, normalize: bool) -> np.ndarray:
    return np.empty(shape, np.float32 if normalize else np.uint8)


def _params_array(params: Sequence[Sequence[int]], n: int) -> np.ndarray:
    arr = np.ascontiguousarray(params, np.int32)
    if arr.shape != (n, 6):
        raise ValueError(f"params must be {n} rows of (mode, left, top, cw, ch, flip), got shape {arr.shape}")
    return arr


def jpeg_size(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None on failure."""
    lib = _native.load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vitax_jpeg_size(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def process_file(path: str, params: Sequence[int], out_size: int, resize_to: int,
                 normalize: bool = True) -> Optional[np.ndarray]:
    """Decode + transform one JPEG file: (S, S, 3) float32 normalized when
    `normalize`, else raw uint8; None on failure."""
    lib = _native.load()
    if lib is None:
        return None
    out = _out((out_size, out_size, 3), normalize)
    mode, left, top, cw, ch, flip = (int(x) for x in params)
    rc = lib.vitax_process_file(path.encode(), mode, left, top, cw, ch, flip, out_size, resize_to,
                                int(normalize), out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def process_batch(paths: Sequence[str], params: Sequence[Sequence[int]], out_size: int,
                  resize_to: int, n_threads: int = 8, normalize: bool = True
                  ) -> Tuple[Optional[np.ndarray], List[int]]:
    """Decode + transform a batch of files on the C++ thread pool. Returns
    (batch (N, S, S, 3), failed indices); a failed slot is left unwritten
    for the caller's PIL path."""
    n = len(paths)
    lib = _native.load()
    if lib is None:
        return None, list(range(n))
    out = _out((n, out_size, out_size, 3), normalize)
    fail = np.zeros(n, np.uint8)
    params_arr = _params_array(params, n)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.vitax_process_batch(c_paths, n, params_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            out_size, resize_to, int(normalize), out.ctypes.data_as(ctypes.c_void_p),
                            fail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return out, [int(i) for i in np.nonzero(fail)[0]]


def jpeg_size_bytes(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from an in-memory JPEG header, or None on failure."""
    lib = _native.load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vitax_jpeg_size_mem(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def process_bytes(data: bytes, params: Sequence[int], out_size: int, resize_to: int,
                  normalize: bool = True) -> Optional[np.ndarray]:
    """Decode + transform one in-memory JPEG, bitwise equal to
    process_file on the same bytes; None on failure."""
    lib = _native.load()
    if lib is None:
        return None
    out = _out((out_size, out_size, 3), normalize)
    mode, left, top, cw, ch, flip = (int(x) for x in params)
    rc = lib.vitax_process_mem(data, len(data), mode, left, top, cw, ch, flip, out_size, resize_to,
                               int(normalize), out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def process_batch_bytes(blobs: Sequence[bytes], params: Sequence[Sequence[int]], out_size: int,
                        resize_to: int, n_threads: int = 8, normalize: bool = True
                        ) -> Tuple[Optional[np.ndarray], List[int]]:
    """Decode + transform a batch of in-memory JPEGs on the C++ thread pool
    (the streaming loader's path); the contract of process_batch."""
    n = len(blobs)
    lib = _native.load()
    if lib is None:
        return None, list(range(n))
    out = _out((n, out_size, out_size, 3), normalize)
    fail = np.zeros(n, np.uint8)
    params_arr = _params_array(params, n)
    # the array holds a reference to each bytes object for the call; the
    # lengths are explicit, so embedded NULs are fine
    c_blobs = (ctypes.c_char_p * n)(*blobs)
    lens = np.asarray([len(b) for b in blobs], np.int32)
    lib.vitax_process_batch_mem(c_blobs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
                                params_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out_size,
                                resize_to, int(normalize), out.ctypes.data_as(ctypes.c_void_p),
                                fail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return out, [int(i) for i in np.nonzero(fail)[0]]
