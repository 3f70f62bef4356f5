"""Persistent XLA compilation cache: one directory, chosen in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, is used exactly; otherwise the
cache lives in ``.jax_cache/`` at the root of the checkout — a fixed path,
so a later run of the same programs finds its entries again (the path is
part of nothing but the location; a temporary or per-run directory would
never hit).  The CLI, ``chip_smoke.py`` and ``bench.py`` call
:func:`enable_compile_cache` before their first compilation; no other
cache directory is set anywhere in the code.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory.  Call it before
    the process compiles anything: JAX decides once, at its first
    compilation, whether a cache is in use."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
