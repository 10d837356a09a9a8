"""Persistent XLA compilation cache setup (the one place that configures it).

JAX (0.9.0 included) reads JAX_COMPILATION_CACHE_DIR from the environment
itself, so when it is set the cache lives there and nothing here names
another path.  Otherwise the cache sits at a fixed directory inside the
checkout, `<repo>/.jax_cache`: the path is part of how a later process
finds an entry, so it never depends on a temporary name, a PID or the time.
Set FASTP_TPU_NO_COMPILE_CACHE=1 to run without a persistent cache.
"""
import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

_done = False


def ensure_compile_cache():
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("FASTP_TPU_NO_COMPILE_CACHE"):
        return
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
