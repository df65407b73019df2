"""Native host-side kernels (C++ via ctypes), compiled on first import.

Provides fast paths for title normalization and packed-index construction
(the reference's numba-JIT host kernels have no Python equivalent fast
enough on one host core).  Falls back to pure numpy/python implementations
when no C++ toolchain is available.

The library is built from the committed ``native.cpp`` into the checkout's
``.cache/native/`` (listed in .gitignore), keyed on the source's hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

from doppelspeller import REPO_ROOT

LOGGER = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "native.cpp")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src).hexdigest()[:16]
        cache_dir = os.path.join(REPO_ROOT, ".cache", "native")
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"doppel_native_{tag}.so")
        if not os.path.exists(so_path):
            tmp = so_path + ".tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.transform_titles_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.build_index_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.build_index_c.restype = ctypes.c_int64
        return lib
    except Exception as exc:  # pragma: no cover - toolchain-dependent
        LOGGER.warning("native module unavailable (%s); using python fallbacks", exc)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("DOPPEL_DISABLE_NATIVE"):
            _LIB = None
        else:
            _LIB = _build_lib()
    return _LIB


def transform_titles_native(titles, max_chars: int, n_grams: int):
    """Batch title transform.  Returns (transformed list[str],
    encoded uint8[n, max_chars], lengths int32[n]) or None if unavailable."""
    import unicodedata

    lib = get_lib()
    if lib is None:
        return None
    n = len(titles)
    nfd = [unicodedata.normalize("NFD", str(t)).encode("utf-8") for t in titles]
    data = b"".join(nfd)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in nfd], out=offsets[1:])
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(0, np.uint8)
    buf = np.ascontiguousarray(buf)
    out_text = np.zeros(n * max_chars, dtype=np.uint8)
    out_lens = np.zeros(n, dtype=np.int32)
    out_enc = np.zeros((n, max_chars), dtype=np.uint8)
    out_flags = np.zeros(n, dtype=np.uint8)
    lib.transform_titles_c(
        buf.ctypes.data, offsets.ctypes.data, n,
        out_text.ctypes.data, out_lens.ctypes.data, out_enc.ctypes.data,
        out_flags.ctypes.data, max_chars, n_grams,
    )
    text = out_text.reshape(n, max_chars)
    transformed = [
        text[i, : out_lens[i]].tobytes().decode("ascii") for i in range(n)
    ]
    # exotic-whitespace rows fall back to the python implementation
    fb = np.flatnonzero(out_flags)
    if len(fb):
        from doppelspeller.utils import text as T

        for i in fb:
            s = T.transform_title(str(titles[i]), max_chars, n_grams)
            transformed[i] = s
            out_lens[i] = min(len(s), max_chars)
            out_enc[i] = T.encode_title(s, max_chars)
    return transformed, out_enc, out_lens


def build_index_native(encoded: np.ndarray, lengths: np.ndarray,
                       vocab_size: int, ntp: int):
    """Packed occupancy matrix + df + flat per-title trigram list.

    Returns (packed uint8[V, ntp//8], df int32[V], flat_ids int32[nnz],
    flat_counts int32[n]) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n, max_chars = encoded.shape
    packed = np.zeros((vocab_size, ntp // 8), dtype=np.uint8)
    df = np.zeros(vocab_size, dtype=np.int32)
    flat_ids = np.zeros(n * max(max_chars - 2, 1), dtype=np.int32)
    flat_counts = np.zeros(n, dtype=np.int32)
    enc = np.ascontiguousarray(encoded)
    lens = np.ascontiguousarray(lengths.astype(np.int32))
    nnz = lib.build_index_c(
        enc.ctypes.data, lens.ctypes.data, n,
        packed.ctypes.data, packed.shape[1],
        df.ctypes.data, flat_ids.ctypes.data, flat_counts.ctypes.data,
        max_chars,
    )
    return packed, df, flat_ids[:nnz], flat_counts
