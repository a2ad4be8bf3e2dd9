"""Persistent caches.

Two layers, both opt-out via ``ITRAILS_NO_CACHE=1``:

1. **XLA compilation cache** (`enable_compilation_cache`): persists compiled
   executables across processes.  When ``JAX_COMPILATION_CACHE_DIR`` is set,
   JAX reads it itself and nothing here overrides it; otherwise the cache
   lives at the fixed path ``<checkout>/.jax_cache`` (listed in
   ``.gitignore``), so every process of one checkout shares it.
2. **Model-artifact cache** (`model_artifact_get`/`put`): the built
   (a, b, pi, cuts) tensors for an exact parameter point, reused across
   processes under ``ITRAILS_CACHE_DIR`` (default ``~/.cache/itrails_tpu``).
   The optimize -> viterbi -> posterior pipeline rebuilds the SAME best-fit
   model in each CLI process; the artifact hit turns that cold-process
   rebuild into a ~10 ms npz load.
"""

from __future__ import annotations

import hashlib
import os

__all__ = [
    "compilation_cache_dir", "enable_compilation_cache",
    "model_artifact_get", "model_artifact_put", "model_artifact_key",
]

_DONE = False
_ARTIFACT_SCHEMA = "v1"  # bump to invalidate all stored model artifacts
_ARTIFACT_KEEP = 64  # newest entries kept by the LRU prune
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cache_root() -> str:
    return os.environ.get(
        "ITRAILS_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "itrails_tpu"),
    )


def compilation_cache_dir() -> str:
    """Directory of the persistent XLA compilation cache."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compilation_cache():
    """Persist XLA compilations across runs, so a later process starts with
    the decode and model-build executables already compiled.  Opt out with
    ITRAILS_NO_CACHE=1."""
    global _DONE
    if _DONE or os.environ.get("ITRAILS_NO_CACHE"):
        return
    _DONE = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX took the directory from the environment
    import jax

    try:
        os.makedirs(compilation_cache_dir(), exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    except OSError:  # cache is an optimization, never a hard failure
        pass


# --- model-artifact cache ---------------------------------------------------


def model_artifact_key(family: str, n_int_AB: int, n_int_ABC: int,
                       dtype_name: str, params, cut_AB=None,
                       cut_ABC=None) -> str:
    """Content key for one built model: family/topology/dtype + the exact
    f64 bit patterns of every parameter (and manual cutpoints, if any).
    The package version and a schema tag are folded in so upgrades
    invalidate cleanly."""
    import numpy as np

    from itrails_tpu import __version__

    h = hashlib.sha1()
    h.update(
        f"{_ARTIFACT_SCHEMA}|{__version__}|{family}|{n_int_AB}|{n_int_ABC}|"
        f"{dtype_name}|".encode()
    )
    h.update(np.asarray(params, np.float64).tobytes())
    for cut in (cut_AB, cut_ABC):
        h.update(b"|")
        if cut is not None:
            h.update(np.asarray(cut, np.float64).tobytes())
    return h.hexdigest()


def _artifact_dir() -> str:
    return os.path.join(_cache_root(), "models")


def model_artifact_get(key: str):
    """Load a cached build, or None.  Returns dict of numpy arrays
    (a, b, pi, cut_AB, cut_ABC) in their stored dtype — bit-identical to
    the build that stored them (the key embeds the build dtype)."""
    if os.environ.get("ITRAILS_NO_CACHE"):
        return None
    path = os.path.join(_artifact_dir(), key + ".npz")
    try:
        import numpy as np

        with np.load(path, allow_pickle=False) as z:
            out = {k: z[k] for k in ("a", "b", "pi", "cut_AB", "cut_ABC")}
        os.utime(path)  # LRU touch
        return out
    except Exception:
        return None


def model_artifact_put(key: str, a, b, pi, cut_AB, cut_ABC) -> None:
    if os.environ.get("ITRAILS_NO_CACHE"):
        return
    import numpy as np

    d = _artifact_dir()
    try:
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{key}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, a=np.asarray(a), b=np.asarray(b),
                     pi=np.asarray(pi), cut_AB=np.asarray(cut_AB),
                     cut_ABC=np.asarray(cut_ABC))
        os.replace(tmp, os.path.join(d, key + ".npz"))
        # LRU prune: keep the newest _ARTIFACT_KEEP entries
        entries = sorted(
            (e for e in os.scandir(d) if e.name.endswith(".npz")),
            key=lambda e: e.stat().st_mtime, reverse=True,
        )
        for e in entries[_ARTIFACT_KEEP:]:
            try:
                os.unlink(e.path)
            except OSError:
                pass
    except Exception:  # cache is an optimization, never a hard failure
        pass
