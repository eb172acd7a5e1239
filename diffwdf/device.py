"""Where the program runs: the kernel route for the device, and the
persistent compile cache.

The Pallas kernels (``ops/fused_circuit.py``) are compiled for the GPU
through Triton.  On the CPU the Pallas interpreter is the only way to run
them, which is what the test suite does.  Any other platform has no route.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

#: default persistent compile cache: a fixed directory inside the checkout
#: (listed in .gitignore), used when JAX_COMPILATION_CACHE_DIR is not set
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def kernel_route(platform: Optional[str] = None) -> str:
    """The Pallas route for ``platform`` (default: JAX's default backend):
    "triton" on a GPU, "interpret" on the CPU.  Any other platform is an
    error — a kernel never falls back to the interpreter on an accelerator."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "interpret"
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r}: the kernels are "
        "compiled for a GPU (Triton) or interpreted on the CPU"
    )


def use_interpret(platform: Optional[str] = None) -> bool:
    """True when the Pallas kernels must run in interpret mode (CPU)."""
    return kernel_route(platform) == "interpret"


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else :data:`DEFAULT_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache at :func:`compile_cache_dir`
    and return the directory.  Compiled programs are then found again by
    the next process started from the same checkout."""
    path = compile_cache_dir()
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
