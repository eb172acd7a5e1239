"""ctypes bindings + on-demand build of the native WDF runtime.

Builds ``wdf_native.cpp`` with g++ on first use (cached as
``build/libwdf_native.so``); pybind11 is not available in this image, so the
C ABI + ctypes is the binding layer.  Falls back gracefully (``available()``)
if no compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "wdf_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "libwdf_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-ffast-math",
        "-fno-finite-math-only",
        "-shared",
        "-fPIC",
        "-o",
        _SO + f".{os.getpid()}",  # renamed into place: concurrent test
        _SRC,  # workers never load a half-written library
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(cmd[-2], _SO)
        return None
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        return getattr(e, "stderr", str(e)) or str(e)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(_SO)
        lib.wdf_wrightomega.restype = ctypes.c_double
        lib.wdf_wrightomega.argtypes = [ctypes.c_double]
        lib.wdf_wrightomega_batch.restype = None
        lib.wdf_wrightomega_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.wdf_clipper_process.restype = None
        lib.wdf_clipper_process.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ] + [ctypes.c_double] * 7
        lib.wdf_clipper_process_neural.restype = None
        lib.wdf_clipper_process_neural.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.wdf_load_csv.restype = ctypes.c_int64
        lib.wdf_load_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    get_lib()
    return _build_error


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------


def wrightomega(x):
    """float64 Wright omega on the real line (native oracle)."""
    lib = get_lib()
    x = np.ascontiguousarray(np.atleast_1d(np.asarray(x, np.float64)))
    out = np.empty_like(x)
    lib.wdf_wrightomega_batch(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        x.size,
    )
    return out


def clipper_process(
    vin,
    z0: float,
    r_source: float,
    cap: float,
    fs: float,
    Is: float,
    vt_eff: float,
    n_up: float = 1.0,
    n_down: float = 1.0,
) -> Tuple[np.ndarray, float]:
    """Single-stream analytic clipper on the CPU engine."""
    lib = get_lib()
    x = np.ascontiguousarray(np.asarray(vin, np.float32))
    out = np.empty_like(x)
    z = ctypes.c_double(z0)
    lib.wdf_clipper_process(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
        ctypes.byref(z),
        r_source,
        cap,
        fs,
        Is,
        vt_eff,
        n_up,
        n_down,
    )
    return out, z.value


def _flatten_mlp(mlp_params):
    """MLP params pytree -> (weights flat, sizes, acts) arrays for the C ABI."""
    layers = mlp_params["layers"]
    sizes = [int(layers[0]["kernel"].shape[0])]
    acts = []
    chunks = []
    for i, l in enumerate(layers):
        k = np.asarray(l["kernel"], np.float32)
        b = np.asarray(l["bias"], np.float32)
        sizes.append(int(k.shape[1]))
        acts.append(1 if i < len(layers) - 1 else 0)  # NxH family: tanh+linear head
        chunks.append(k.reshape(-1))
        chunks.append(b.reshape(-1))
    return (
        np.concatenate(chunks).astype(np.float32),
        np.asarray(sizes, np.int32),
        np.asarray(acts, np.int32),
    )


def clipper_process_neural(
    vin, z0: float, mlp_params, r_source: float, cap: float, fs: float
) -> Tuple[np.ndarray, float]:
    """Single-stream neural clipper on the CPU engine (RTNeural role)."""
    lib = get_lib()
    weights, sizes, acts = _flatten_mlp(mlp_params)
    x = np.ascontiguousarray(np.asarray(vin, np.float32))
    out = np.empty_like(x)
    z = ctypes.c_double(z0)
    lib.wdf_clipper_process_neural(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
        ctypes.byref(z),
        r_source,
        cap,
        fs,
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        acts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(sizes) - 1,
    )
    return out, z.value


def load_csv(path: str) -> Tuple[np.ndarray, np.ndarray, float]:
    """Fast native CSV loader (reference measurement format)."""
    lib = get_lib()
    fs = ctypes.c_double(0.0)
    n = lib.wdf_load_csv(path.encode(), None, None, 0, ctypes.byref(fs))
    if n < 0:
        raise FileNotFoundError(path)
    vin = np.empty(n, np.float32)
    vout = np.empty(n, np.float32)
    lib.wdf_load_csv(
        path.encode(),
        vin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vout.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        ctypes.byref(fs),
    )
    return vin, vout, fs.value
