"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source in ops/csrc/ is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, in `build/torch_ext/` at the root
of the checkout (listed in .gitignore). All sources compile in parallel, one
nvcc process each. A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused. The
kernels take device pointers, shapes and the stream from the Python wrappers
in ops/flash_attention.py, the repo's ctypes idiom for native code. A build
or load failure raises; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "torch_ext"
)
NVCC_FLAGS = [
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source name -> (C entry point, argtypes)
KERNELS = {
    "flash_fwd": ("edl_flash_fwd", [_P] * 5 + [_I] * 5 + [_F, _P]),
    "flash_dq": ("edl_flash_dq", [_P] * 7 + [_I] * 5 + [_F, _P]),
    "flash_dkv": ("edl_flash_dkv", [_P] * 8 + [_I] * 5 + [_F, _P]),
}
_HEADERS = ("flash_common.cuh", "flash_mma.cuh")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME:
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME): the port's CUDA kernels "
            "are built from source at first use"
        )
    return path


def _library_path(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build():
    """Compiles every kernel source that is not built yet, all in parallel.
    Returns {name: seconds spent building} for those it built; raises
    RuntimeError with the compiler's output if any build fails. The
    compiler's report (registers, shared memory, spills from -Xptxas -v) is
    kept beside each library as <library>.log."""
    todo = [n for n in KERNELS if not os.path.exists(_library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name in todo:
        out = _library_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    seconds, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        with open(f"{out}.log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def library(name):
    """The loaded library of kernel source `name`, building the kernels
    first if needed (all of them at once: a training step needs all)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build()
            lib = ctypes.CDLL(_library_path(name))
            entry, argtypes = KERNELS[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.edl_flash_error_string.argtypes = [ctypes.c_int]
            lib.edl_flash_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def call(name, *args):
    """Calls kernel source `name`'s C entry point; raises on a launch error
    (a refused launch never runs, and a later synchronize would not say
    so)."""
    lib = library(name)
    code = getattr(lib, KERNELS[name][0])(*args)
    if code != 0:
        msg = lib.edl_flash_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
