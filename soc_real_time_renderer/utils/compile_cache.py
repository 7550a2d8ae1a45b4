"""Persistent XLA compilation cache.

The reference hot-reloads shaders per frame (renderer.cpp:634-640); the
analog of that iteration loop here is jit recompilation, which costs
tens of seconds per static-config change.  The persistent cache makes
every re-run of an already-seen (config, shape) combination load the
compiled executable from disk instead, across processes (entries are
keyed by program fingerprint and backend).

Directory: ``JAX_COMPILATION_CACHE_DIR`` when it is set, and no other;
otherwise the fixed ``<checkout>/.jax_cache`` (a fixed path, because
the path is part of what makes a later run find the entries).

Call :func:`enable` after importing jax, before the first jit dispatch.
tests/conftest.py calls it for the test suite.
"""
import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent compilation cache (idempotent); returns
    the directory in use."""
    import jax
    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    # cache everything: tiny entries and fast compiles included — the
    # frame graph is a handful of large programs, not thousands of tiny
    # ones, so there is no eviction pressure.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return d
