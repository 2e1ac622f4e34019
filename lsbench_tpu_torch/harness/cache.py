"""Setup cache (counterpart of `lsbench_tpu/harness/cache.py`): the
expensive host setup products (fill-reducing orderings, sparse Cholesky
factors, AMG hierarchies) stored as `.npz` files keyed by a content hash of
the matrix, since setup dominates the end-to-end time of a trials sweep.

Off by default, as the reference re-reads and re-factors on every run;
`--cache` on the CLI or `LSBENCH_CACHE=1` turns it on. The entries live
under `$LSBENCH_CACHE_DIR`, by default `~/.cache/lsbench_tpu_torch`, a
directory of the port's own. The key functions, file names and array
layout are the JAX package's, so an entry either package wrote is one the
other reads when both are pointed at the same directory.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from pathlib import Path

import numpy as np

_enabled = os.environ.get("LSBENCH_CACHE", "0") not in ("", "0", "false")
_root: Path | None = None


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def cache_dir() -> Path:
    global _root
    if _root is None:
        _root = Path(os.environ.get(
            "LSBENCH_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "lsbench_tpu_torch")))
    return _root


def set_cache_dir(path) -> None:
    global _root
    _root = Path(path)


def fingerprint_csr(A) -> str:
    """Content hash of a CsrMatrix (shape, structure and values)."""
    h = hashlib.sha256()
    h.update(np.asarray([A.nrows, A.ncols], dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.offs).tobytes())
    h.update(np.ascontiguousarray(A.cols).tobytes())
    h.update(np.ascontiguousarray(A.vals).tobytes())
    return h.hexdigest()[:24]


def fingerprint_pattern(A) -> str:
    """Structure-only hash (shape, offs, cols; values excluded): the key of
    same-pattern re-setup, where a re-assembly keeps the sparsity and only
    the values change."""
    h = hashlib.sha256()
    h.update(np.asarray([A.nrows, A.ncols], dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.offs).tobytes())
    h.update(np.ascontiguousarray(A.cols).tobytes())
    return h.hexdigest()[:24]


def _path(kind: str, key: str) -> Path:
    return cache_dir() / f"{kind}-{key}.npz"


def key_of(*parts) -> str:
    """Hash of the `repr` of each part: a part must print as the JAX
    package's does (a float, not a numpy scalar; a tuple, not a list) for
    the two packages to share a key."""
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:24]


def load_arrays(kind: str, key: str) -> dict | None:
    """Return {name: array}, or None on a miss or a corrupt entry (which is
    deleted, so that the caller rebuilds and stores it again)."""
    if not _enabled:
        return None
    p = _path(kind, key)
    if not p.is_file():
        return None
    try:
        with np.load(p, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        try:
            p.unlink()
        except OSError:
            pass
        return None


def store_arrays(kind: str, key: str, arrays: dict) -> None:
    if not _enabled:
        return
    d = cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    # One temporary file per process: the ranks of a `--devices` run store
    # the same entry at once.
    tmp = _path(kind, key).with_suffix(f".{os.getpid()}.tmp.npz")
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, _path(kind, key))
    except OSError:
        pass  # the cache is best-effort


def clear() -> int:
    """Delete all cache entries; returns the number removed."""
    d = cache_dir()
    n = 0
    if d.is_dir():
        for f in d.glob("*.npz"):
            try:
                f.unlink()
                n += 1
            except OSError:
                pass
    return n
