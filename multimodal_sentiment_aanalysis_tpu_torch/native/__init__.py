"""The C++ data runtime, bound through ``ctypes``.

The port's copy of ``multimodal_sentiment_aanalysis_tpu/native``:
``dataruntime.cpp`` builds with ``g++`` on first use into
``build/native/`` at the root of the checkout (the file name carries a
hash of the source and flags), never beside the source. A missing
compiler or a failed build raises: there is no fallback. The ``*_plain``
functions are the numpy versions that the tests hold the library to.

- :func:`nan_to_num_`: in-place NaN/Inf scrub;
- :func:`zscore_columns_`: in-place per-feature z-score, ``std == 0`` guard;
- :func:`global_norm_`: in-place global z-score then min-max;
- :func:`build_pairs`: balanced within-subject contrastive pairs drawn with
  splitmix64 (the same pair semantics as
  :func:`..data.pairs.build_contrastive_pairs`, another subsample).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dataruntime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``dataruntime.cpp`` unless its current build exists; return
    the library's path."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"dataruntime-{digest}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data runtime builds from source on "
                           "first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, u64 = ctypes.c_int64, ctypes.c_uint64
            f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
            lib.msa_nan_to_num.argtypes = [f32p, i64]
            lib.msa_zscore_columns.argtypes = [f32p, i64, i64]
            lib.msa_global_norm.argtypes = [f32p, i64]
            lib.msa_build_pairs.argtypes = [i64p, i64p, i64p, i64, u64,
                                            ctypes.POINTER(ctypes.c_int32), f32p, i64]
            lib.msa_build_pairs.restype = i64
            _lib = lib
        return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check_f32(x: np.ndarray, ndim: int | None = None) -> None:
    if x.dtype != np.float32 or not x.flags.c_contiguous or (ndim and x.ndim != ndim):
        raise ValueError(f"needs a C-contiguous float32 array"
                         f"{f' of {ndim} dims' if ndim else ''}, got {x.dtype} {x.shape}")


def nan_to_num_(x: np.ndarray) -> np.ndarray:
    """In-place ``np.nan_to_num`` of a contiguous float32 array."""
    _check_f32(x)
    _load().msa_nan_to_num(_f32p(x), x.size)
    return x


def zscore_columns_(x: np.ndarray) -> np.ndarray:
    """In-place per-feature z-score over axis 0 of an ``(n, d)`` float32 array."""
    _check_f32(x, 2)
    _load().msa_zscore_columns(_f32p(x), x.shape[0], x.shape[1])
    return x


def global_norm_(x: np.ndarray) -> np.ndarray:
    """In-place global z-score then min-max over the whole array."""
    _check_f32(x)
    _load().msa_global_norm(_f32p(x), x.size)
    return x


def _pair_capacity(subject_ids: np.ndarray) -> int:
    """Every unordered pair within each subject: the most pairs there can be."""
    _, counts = np.unique(subject_ids, return_counts=True)
    return int((counts * (counts - 1) // 2).sum()) or 1


def build_pairs(arousal: np.ndarray, valence: np.ndarray, subject_ids: np.ndarray,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Balanced within-subject contrastive pairs: ``(pairs (P, 2) int32,
    labels (P,) float32)``, a pair positive iff both labels agree, each
    subject's positives and negatives down-sampled to the smaller count and
    shuffled; subjects lacking either class add none."""
    a = np.ascontiguousarray(arousal, np.int64)
    v = np.ascontiguousarray(valence, np.int64)
    s = np.ascontiguousarray(subject_ids, np.int64)
    cap = _pair_capacity(s)
    out_pairs = np.empty((cap, 2), np.int32)
    out_labels = np.empty((cap,), np.float32)
    wrote = _load().msa_build_pairs(
        _i64p(a), _i64p(v), _i64p(s), len(a), ctypes.c_uint64(seed),
        out_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _f32p(out_labels), cap)
    return out_pairs[:wrote].copy(), out_labels[:wrote].copy()


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def nan_to_num_plain(x: np.ndarray) -> np.ndarray:
    return np.nan_to_num(x)


def zscore_columns_plain(x: np.ndarray) -> np.ndarray:
    """Per-feature z-score in float64, ``std == 0 -> 1``, cast to float32."""
    mean = x.mean(axis=0, dtype=np.float64)
    std = x.std(axis=0, dtype=np.float64)
    return ((x - mean) / np.where(std == 0, 1.0, std)).astype(np.float32)


def global_norm_plain(x: np.ndarray) -> np.ndarray:
    """Global z-score then min-max in float64, cast to float32."""
    mean, std = np.mean(x, dtype=np.float64), np.std(x, dtype=np.float64)
    z = (x - mean) / (std if std != 0 else 1.0)
    return ((z - z.min()) / max(z.max() - z.min(), 1e-300)).astype(np.float32)


_U64 = (1 << 64) - 1


class _SplitMix64:
    """The C++ runtime's generator, in Python integers."""

    def __init__(self, seed: int):
        self.s = seed & _U64

    def below(self, bound: int) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & _U64
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        return (z ^ (z >> 31)) % bound


def _sample_k(v: list[int], k: int, rng: _SplitMix64) -> list[int]:
    """``k`` distinct elements of ``v`` by a partial Fisher-Yates shuffle."""
    for i in range(k):
        j = i + rng.below(len(v) - i)
        v[i], v[j] = v[j], v[i]
    return v[:k]


def build_pairs_plain(arousal: np.ndarray, valence: np.ndarray, subject_ids: np.ndarray,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """:func:`build_pairs` step by step in Python: the same draws, the same
    pairs."""
    a, v, s = (np.asarray(t, np.int64) for t in (arousal, valence, subject_ids))
    rng = _SplitMix64(seed)
    pairs: list[tuple[int, int]] = []
    labels: list[float] = []
    for subj in np.unique(s):
        idx = np.flatnonzero(s == subj).tolist()
        m = len(idx)
        pos: list[int] = []
        neg: list[int] = []
        for p in range(m):
            for q in range(p + 1, m):
                i, j = idx[p], idx[q]
                (pos if a[i] == a[j] and v[i] == v[j] else neg).append(p * m + q)
        if not pos or not neg:
            continue
        keep = min(len(pos), len(neg))
        enc = _sample_k(pos, keep, rng) + _sample_k(neg, keep, rng)
        lab = [1.0] * keep + [0.0] * keep
        for i in range(len(enc) - 1, 0, -1):
            j = rng.below(i + 1)
            enc[i], enc[j] = enc[j], enc[i]
            lab[i], lab[j] = lab[j], lab[i]
        pairs += [(idx[e // m], idx[e % m]) for e in enc]
        labels += lab
    return (np.array(pairs, np.int32).reshape(-1, 2), np.array(labels, np.float32))
