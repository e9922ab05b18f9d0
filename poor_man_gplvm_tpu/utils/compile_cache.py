"""Where JAX's persistent compilation cache lives."""

import os


def compile_cache_dir(default_dir):
    """``$JAX_COMPILATION_CACHE_DIR`` when it is set, else ``default_dir``.

    Callers pass one fixed directory (never a temporary, pid- or
    time-based one): the cache is found again only at the same path."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_dir
