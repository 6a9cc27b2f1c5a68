"""ctypes binding to the native merge/baseline engine (native/gadev.cpp).

Builds the shared library on demand with `make -C native` when it is missing
(g++ is part of the supported toolchain). `available()` says whether it
loaded and `load_error` why not; merge.engine's "auto" backend then uses the
pure-Python spec merge and says so on stderr.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
# GADEV_SO overrides the library path (the sanitizer test lane points it at
# the ASan/UBSan build, tests/test_sanitizers.py)
_SO_PATH = os.environ.get("GADEV_SO", os.path.join(_NATIVE_DIR, "libgadev.so"))

_lock = threading.Lock()
_lib = None
load_error: str | None = None


def _load() -> ctypes.CDLL | None:
    global _lib, load_error
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s"],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except subprocess.CalledProcessError as e:
                load_error = f"make -C native failed: {e.stderr!r}"
                return None
            except (subprocess.SubprocessError, OSError) as e:
                load_error = f"make -C native failed: {e}"
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:
            load_error = f"cannot load {_SO_PATH}: {e}"
            return None
        lib.gadev_assemble.restype = ctypes.c_void_p
        lib.gadev_assemble.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_uint,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.gadev_contigs_from_reads.restype = ctypes.c_void_p
        lib.gadev_contigs_from_reads.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.gadev_count_kmers.restype = ctypes.c_long
        lib.gadev_count_kmers.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.gadev_breakscore.restype = None
        lib.gadev_breakscore.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.gadev_result_count.restype = ctypes.c_int
        lib.gadev_result_count.argtypes = [ctypes.c_void_p]
        lib.gadev_result_get.restype = ctypes.POINTER(ctypes.c_char)
        lib.gadev_result_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.gadev_result_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _collect_results(lib, handle) -> list[str]:
    try:
        n = lib.gadev_result_count(handle)
        out = []
        ln = ctypes.c_int()
        for i in range(n):
            ptr = lib.gadev_result_get(handle, i, ctypes.byref(ln))
            out.append(ctypes.string_at(ptr, ln.value).decode())
        return out
    finally:
        lib.gadev_result_free(handle)


def assemble_native(
    contigs: list[str],
    dbg_kmer: int,
    seed: int,
    n_orderings: int,
    n_threads: int | None = None,
) -> list[str]:
    """Shuffle+merge+dedup across the ordering ensemble in native code.
    Returns solutions sorted by (-length, lexicographic)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    buf = "".join(contigs).encode()
    lens = (ctypes.c_int * len(contigs))(*[len(c) for c in contigs])
    handle = lib.gadev_assemble(
        buf, lens, len(contigs), dbg_kmer, seed, n_orderings, n_threads
    )
    return _collect_results(lib, handle)


def contigs_from_reads_native(reads: list[str], dbg_kmer: int) -> list[str]:
    """Single-threaded hash-map contig construction (benchmark baseline)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if not reads:
        return []
    read_len = len(reads[0])
    assert all(len(r) == read_len for r in reads)
    buf = "".join(reads).encode()
    handle = lib.gadev_contigs_from_reads(buf, len(reads), read_len, dbg_kmer)
    return _collect_results(lib, handle)


def breakscore_native(paths: list[str], reads: list[str],
                      probs_combined: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Single-threaded breakage scoring (benchmark baseline; semantics of
    spec.calc_breakscore's bp_score/kmer_breaks)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    read_len = len(reads[0])
    pbuf = "".join(paths).encode()
    plens = (ctypes.c_int * len(paths))(*[len(s) for s in paths])
    rbuf = "".join(reads).encode()
    probs = np.ascontiguousarray(probs_combined, dtype=np.float64)
    scores = np.zeros(len(paths), np.float64)
    breaks = np.zeros(len(paths), np.int64)
    lib.gadev_breakscore(
        pbuf, plens, len(paths), rbuf, len(reads), read_len,
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        breaks.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return scores, breaks


def count_kmers_native(reads: list[str], k: int) -> np.ndarray:
    """Single-threaded rolling k-mer counter (benchmark baseline)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    read_len = len(reads[0])
    buf = "".join(reads).encode()
    counts = np.zeros(4**k, dtype=np.int64)
    lib.gadev_count_kmers(
        buf, len(reads), read_len, k,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return counts
