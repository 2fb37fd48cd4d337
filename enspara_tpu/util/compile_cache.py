"""Persistent XLA compilation cache.

The engine's while_loops and the eigensolver take seconds to compile;
caching compiled executables on disk makes that a once-per-machine cost.
Enabled by the apps and the bench harness.

Where ``$JAX_COMPILATION_CACHE_DIR`` is set, jax already keeps its cache
there and this module sets no other directory. Otherwise the cache
lives at a fixed path inside the checkout, ``<repo>/.jax_cache``, so a
later run of the same checkout finds it.

The cache stays off on the CPU backend: XLA:CPU's cache key does not
capture the compiling machine's vector extensions, so an entry compiled
on an AVX-512 host can be loaded on a lesser one and die with SIGILL.
"""

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def enable_compilation_cache():
    """Turn on the persistent cache for accelerator compiles. Returns
    the directory in use, or None where the cache stays off."""
    import jax

    from .backend import on_accelerator

    if not on_accelerator():
        return None
    loc = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if not loc:
        loc = DEFAULT_DIR
        jax.config.update('jax_compilation_cache_dir', loc)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    return loc
