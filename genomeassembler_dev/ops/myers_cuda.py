"""The Myers Levenshtein CUDA kernel (ops/cuda/myers.cu) as a JAX operation.

The kernel is built with nvcc for sm_90a into `<repo>/build/` the first time
a process needs it (the file name carries a hash of the source, so an edited
kernel is rebuilt), registered as an XLA FFI target for the CUDA platform,
and called through `jax.ffi.ffi_call`. The build needs the CUDA toolkit
(`$CUDA_HOME`, default /usr/local/cuda) and counts as set-up time.

What stays in Python is tested on the CPU: the launch shape
(`launch_config`) and the input normalisation. The kernel itself runs only
on the card (tests marked `gpu`, and chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cuda", "myers.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_TARGET = "gadev_myers_levenshtein"
_WORDS_PER_THREAD = (1, 2, 4)
MAX_THREADS = 1024
# widest query the kernel takes: 4096 words = 131,072 bases (a 2x-length
# solution of a 64 kb segment)
MAX_QUERY_LEN = 32 * MAX_THREADS * _WORDS_PER_THREAD[-1]


def launch_config(query_width: int) -> tuple[int, int]:
    """(words per thread, threads per block) for queries of `query_width`
    bases: the fewest words per thread that fit the block, so the wavefront
    over a query's words is as short as the block allows."""
    W = max(1, -(-query_width // 32))
    for wpt in _WORDS_PER_THREAD:
        if W <= MAX_THREADS * wpt:
            threads = -(-W // wpt)
            return wpt, -(-threads // 32) * 32
    raise ValueError(
        f"query width {query_width} exceeds the Myers kernel's limit of "
        f"{MAX_QUERY_LEN} bases")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the Myers CUDA kernel cannot be built")
    return nvcc


def build_library() -> str:
    """Compile ops/cuda/myers.cu (once per source version); returns the
    shared library's path."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libgadev_myers_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent builder sees a whole file
    return so


_register_lock = threading.Lock()
_registered = False


def _register() -> None:
    global _registered
    # the batched runner traces stages on background compile threads
    with _register_lock:
        if not _registered:
            lib = ctypes.cdll.LoadLibrary(build_library())
            jax.ffi.register_ffi_target(
                _TARGET, jax.ffi.pycapsule(lib.GadevMyersLevenshtein),
                platform="CUDA")
            _registered = True


@partial(jax.jit, static_argnames=("mode",))
def batched_levenshtein_cuda(
    queries: jnp.ndarray,  # [B, M] base codes 0..3 (pad arbitrary)
    query_lens: jnp.ndarray,  # [B] int32
    target: jnp.ndarray,  # [N] base codes (exact length)
    mode: str = "NW",
) -> jnp.ndarray:
    """Edit distance of each query vs the target on the GPU. Returns [B]
    int32, equal to ops.edit_distance.batched_levenshtein. Under vmap the
    call stays one kernel launch: every batched operand gets the leading
    axis and the kernel pairs each group of B queries with its target."""
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    _register()
    B, M = queries.shape
    wpt, threads = launch_config(M)
    call = jax.ffi.ffi_call(
        _TARGET, jax.ShapeDtypeStruct((B,), jnp.int32),
        vmap_method="broadcast_all")
    return call(queries.astype(jnp.uint8), query_lens.astype(jnp.int32),
                target.astype(jnp.uint8), hw=np.int32(mode == "HW"),
                wpt=np.int32(wpt), threads=np.int32(threads))
