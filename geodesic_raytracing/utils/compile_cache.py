"""Where JAX keeps its persistent compilation cache.

Every entry point calls :func:`enable` before it compiles anything.  The
cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when that is set, and
otherwise at a fixed directory inside the checkout (``.jax_cache``, listed
in ``.gitignore``): a cache entry is only found again under the same path,
so the path never comes from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir(environ=os.environ) -> str:
    """The cache directory: the environment's choice, else the fixed
    in-checkout default."""
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable(subdir: str | None = None) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`
    (optionally a ``subdir`` of it) and return the path."""
    import jax

    path = cache_dir()
    if subdir:
        path = os.path.join(path, subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
