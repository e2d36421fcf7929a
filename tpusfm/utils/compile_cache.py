"""Persistent XLA compilation cache.

Compiling the pipeline's programs is a large share of a cold run.  JAX's
persistent compilation cache turns every compiled executable into a
one-time cost for a given cache directory:

- if JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
  leaves it exactly as given;
- otherwise the cache lives at the fixed `<checkout>/.jax_cache` (a fixed
  path, because the path is part of the cache key: a directory that moves
  never hits).  On the CPU platform it is namespaced by a fingerprint of
  the host CPU's features, because XLA:CPU caches ahead-of-time
  executables built for the compiling machine's instruction set.
"""

from __future__ import annotations

import hashlib
import os
import platform

import jax

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def _host_fingerprint() -> str:
    """Short stable hash of this host's CPU feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    key = f"{platform.machine()}|{flags}"
    return hashlib.sha256(key.encode()).hexdigest()[:12]


def enable() -> str:
    """Turn the persistent compilation cache on (idempotent); returns its
    directory.  Call it before the first compilation."""
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = DEFAULT_DIR
        if jax.default_backend() == "cpu":
            d = os.path.join(DEFAULT_DIR, _host_fingerprint())
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # Cache every program: the default 1 s floor leaves the long tail of
    # small glue programs (broadcasts, concatenates, converts) to be
    # compiled again in every fresh process.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
