"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each source under ``vitax_torch/csrc/`` compiles, at first use, into a
shared library with a plain C interface under ``vitax_torch/_build/``
(listed in .gitignore), or under the directory `set_build_dir` names
(--compile_cache_dir), named by a hash of its source so an edited source
never loads a stale library and a library already there is loaded
without nvcc. A plain-C library builds in seconds, where a
source that includes PyTorch's headers takes minutes. Nothing here runs at
import: the CPU tests import every module of the port on a host with no
nvcc and no card.

``LAUNCHES`` counts kernel launches by name: one key per source, plus
``flash_attn_fwd_drop`` and ``flash_attn_bwd_drop`` for the attention
kernels' dropout instantiations, and the four ``STREAM_KERNELS`` keys for
the same kernels launched past 2048 tokens, where the streaming entries
(ops/flash_blocked.py) take over (ops/attention.py `launch_key`), the two
`FLASH_FWD_KERNELS` keys that split every attention forward launch
between the forward's wgmma and its general kernel (ops/attention.py
`choose_fwd_kernel`), the two `FLASH_BWD_KERNELS` keys that split every
backward call the same way (`choose_bwd_kernel`), and the two
`DEQUANT_KERNELS` keys that split
`dequant_matmul`'s launches the same way (ops/dequant_matmul.py
`choose_kernel`). A
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels.

``CALLS`` counts the calls of the two dispatchers that pick between a
kernel and its plain version (ops/fused_optimizer.py fused_clip_adamw,
ops/dequant_matmul.py dequant_matmul), whichever path they take, under
their kernel's name; each call runs inside `dispatch`, which also tells
the open op recorders (analysis/trace.py OpRecorder) where the call
begins and ends, so the ops of a plain version on the CPU are filed under
its kernel. `builds()` counts the libraries built or found on disk.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(PKG_DIR, "_build")
BUILD_DIR = DEFAULT_BUILD_DIR

# One entry per kernel source: name -> file under csrc/. The shared headers
# (csrc/*.cuh) are compiled into each of them.
SOURCES = {"flash_attn_fwd": "flash_attn_fwd.cu", "flash_attn_bwd": "flash_attn_bwd.cu",
           "fused_adamw": "fused_adamw.cu", "dequant_matmul": "dequant_matmul.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DROPOUT_KERNELS = ("flash_attn_fwd_drop", "flash_attn_bwd_drop")
STREAM_KERNELS = ("flash_attn_fwd_stream", "flash_attn_bwd_stream", "flash_attn_fwd_stream_drop",
                  "flash_attn_bwd_stream_drop")
FLASH_FWD_KERNELS = ("flash_attn_fwd_wgmma", "flash_attn_fwd_general")
FLASH_BWD_KERNELS = ("flash_attn_bwd_wgmma", "flash_attn_bwd_general")
DEQUANT_KERNELS = ("dequant_matmul_wgmma", "dequant_matmul_general")
LAUNCHES: Dict[str, int] = {name: 0 for name in (*SOURCES, *DROPOUT_KERNELS, *STREAM_KERNELS, *FLASH_FWD_KERNELS,
                                                 *FLASH_BWD_KERNELS, *DEQUANT_KERNELS)}

DISPATCHERS = ("fused_adamw", "dequant_matmul")
CALLS: Dict[str, int] = {name: 0 for name in DISPATCHERS}
# objects with enter(name) and exit(name): analysis/trace.py OpRecorder
WATCHERS: List[object] = []

_libs: Dict[str, ctypes.CDLL] = {}
_build_log: Dict[str, dict] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def dispatch(name: str) -> Iterator[None]:
    """One call of `name`'s dispatcher: counted in CALLS, and announced to
    the WATCHERS around its body."""
    CALLS[name] += 1
    for w in WATCHERS:
        w.enter(name)
    try:
        yield
    finally:
        for w in WATCHERS:
            w.exit(name)


def builds() -> int:
    """Kernel libraries this process built or found on disk so far: a
    first use of a kernel in traffic shows as one more."""
    return len(_build_log)


def set_build_dir(path: str) -> str:
    """Build and reuse the libraries under `path` from now on ("" = the
    default vitax_torch/_build): --compile_cache_dir, the persistent cache
    that lets a restart skip the build. Libraries already bound stay bound.
    Returns the directory."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = os.path.abspath(path) if path else DEFAULT_BUILD_DIR
        for name in [n for n in _build_log if n not in _libs]:
            del _build_log[name]        # built elsewhere, not bound: look again under the new directory
    return BUILD_DIR


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's usual prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH "
                       "(the port's kernels are built from vitax_torch/csrc/ at first use)")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the shared
    headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _compile(name: str) -> dict:
    """nvcc one source into its library (atomic rename, so a concurrent or
    interrupted build never leaves a half-written .so); returns the build log."""
    out = _lib_path(name)
    if os.path.exists(out):
        return {"name": name, "seconds": 0.0, "cached": True, "ptxas": "", "path": out}
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} (rc {r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"name": name, "seconds": time.perf_counter() - t0, "cached": False,
            "ptxas": r.stderr.strip(), "path": out}


def build_all() -> Dict[str, dict]:
    """Compile every kernel source, one nvcc per source, all started
    together. Returns {name: build log} (seconds, ptxas register and shared
    memory report)."""
    with _lock:
        todo = [n for n in SOURCES if n not in _build_log]
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as pool:
                for log in pool.map(_compile, todo):
                    _build_log[log["name"]] = log
        return dict(_build_log)


def load(name: str) -> ctypes.CDLL:
    """The bound library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name not in _build_log:
                _build_log[name] = _compile(name)
            lib = ctypes.CDLL(_build_log[name]["path"])
            lib.vitax_cuda_error_string.argtypes = [ctypes.c_int]
            lib.vitax_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def load_variant(path: str, tag: str) -> ctypes.CDLL:
    """A copy of a kernel source with one change (a variant, for the A/B
    tools in vitax_torch/tools), built with the same flags into
    `_build/lib<tag>.so` and bound; its nvcc report is the library's
    `ptxas` attribute."""
    out = os.path.join(BUILD_DIR, f"lib{tag}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", out, path], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{r.stderr}")
    lib = ctypes.CDLL(out)
    lib.vitax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vitax_cuda_error_string.restype = ctypes.c_char_p
    lib.ptxas = r.stderr
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = lib.vitax_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
