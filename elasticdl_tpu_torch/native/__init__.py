"""The port's host library: builds kernels.cc, idmap.cc, recordio.cc and
codec.cc with g++ at first use and loads them with ctypes (counterpart of
elasticdl_tpu/native/__init__.py).

kernels.cc and idmap.cc are copies of the JAX package's, compiled with the
same flags, so both packages apply the same optimizer updates and create the
same embedding rows bit for bit. recordio.cc is the JAX package's range read
of `.edlr` files (data/recordfile.py) with its own CRC32 in place of zlib's.
codec.cc is the port's own: the columnar
Example decode (data/example.py) and the bfloat16 rounding of the wire
(common/tensor_utils.py), which the JAX package gets from protobuf's and
ml_dtypes' compiled code. The library goes to `build/torch_ext/` at the
root of the checkout (listed in .gitignore), its file name carrying a hash
of the sources and flags, as the CUDA kernels' do (ops/_build.py). These
are host kernels: the parameter server's store lives in host memory, and
records are decoded on the worker's host.

A failed build or load raises. There is no numpy fallback on the main path:
the numpy rules in ps/optimizer.py, the Python codec of proto/messages.py,
the numpy rounding of common/tensor_utils.py and the Python record reader
are the plain references the tests hold the library against. EDL_NO_NATIVE=1
is the one explicit way to the Python record reader, as in the JAX
package.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from elasticdl_tpu_torch.ops._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("kernels.cc", "idmap.cc", "recordio.cc", "codec.cc")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
             "-shared"]

_lock = threading.Lock()
_lib = None


def f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


NULL_F32 = ctypes.POINTER(ctypes.c_float)()


def _declare(lib):
    f32ptr = ctypes.POINTER(ctypes.c_float)
    i64ptr = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    f32 = ctypes.c_float
    sigs = {
        "edl_sgd": [f32ptr, f32ptr, f32, i64],
        "edl_momentum": [f32ptr, f32ptr, f32ptr, f32, f32, ctypes.c_int, i64],
        "edl_adam": [f32ptr, f32ptr, f32ptr, f32ptr, f32ptr, f32, i64, f32,
                     f32, f32, i64],
        "edl_adagrad": [f32ptr, f32ptr, f32ptr, f32, f32, i64],
        "edl_sgd_indexed": [f32ptr, i64ptr, i64, i64, f32ptr, f32],
        "edl_momentum_indexed": [f32ptr, i64ptr, i64, i64, f32ptr, f32ptr,
                                 f32, f32, ctypes.c_int],
        "edl_adam_indexed": [f32ptr, i64ptr, i64, i64, f32ptr, f32ptr,
                             f32ptr, f32ptr, f32, i64, f32, f32, f32],
        "edl_adagrad_indexed": [f32ptr, i64ptr, i64, i64, f32ptr, f32ptr,
                                f32, f32],
        "edl_gather_rows": [f32ptr, i64ptr, i64, i64, f32ptr],
        "edl_scatter_rows": [f32ptr, i64ptr, i64, i64, f32ptr],
        "edl_uniform_init": [f32ptr, i64, f32, f32, ctypes.c_uint64],
        "edl_uniform_init_rows": [f32ptr, i64, i64, i64, f32, f32,
                                  ctypes.c_uint64],
        "edl_normal_init_rows": [f32ptr, i64, i64, i64, f32, f32,
                                 ctypes.c_uint64, ctypes.c_int],
        "edl_idmap_free": [ctypes.c_void_p],
        "edl_idmap_export_ids": [ctypes.c_void_p, i64, i64, i64ptr],
        "edl_f32_to_bf16": [ctypes.c_void_p, ctypes.c_void_p, i64],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    lib.edl_idmap_new.argtypes = [i64]
    lib.edl_idmap_new.restype = ctypes.c_void_p
    lib.edl_idmap_size.argtypes = [ctypes.c_void_p]
    lib.edl_idmap_size.restype = i64
    lib.edl_idmap_rows_for_ids.argtypes = [
        ctypes.c_void_p, i64ptr, i64, ctypes.c_int, i64ptr,
    ]
    lib.edl_idmap_rows_for_ids.restype = i64
    lib.edl_dedup_sum.argtypes = [i64ptr, f32ptr, i64, i64, i64ptr, f32ptr]
    lib.edl_dedup_sum.restype = i64
    lib.edl_decode_examples.argtypes = [
        ctypes.c_char_p, i64ptr, i64, i64, ctypes.c_char_p, i64ptr, i64ptr,
        i64ptr, i64ptr, i64ptr, i64ptr, ctypes.POINTER(ctypes.c_void_p),
        i64ptr, i64ptr,
    ]
    lib.edl_decode_examples.restype = i64
    lib.edl_records_read.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, i64ptr,
    ]
    lib.edl_records_read.restype = ctypes.c_longlong
    return lib


def library_path():
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libedl_ps-{digest.hexdigest()[:16]}.so")


def build():
    """Compiles the library if it is not built yet; raises RuntimeError with
    the compiler's output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the parameter server's host library is built "
            "from source at first use"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp,
           *(os.path.join(_HERE, name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the parameter server's host library failed "
            f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def lib():
    """The loaded library, building it on the first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                _lib = _declare(ctypes.CDLL(library_path()))
    return _lib
