"""Profiling helpers: device traces and wall-clock phase timers.

The reference's only observability is tqdm bars and returned histories
(SURVEY.md §5); equivalents here: ``jax.profiler`` trace capture (for
xprof/tensorboard) and a lightweight phase timer used by
``fit_em(profile=True)``.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["trace", "PhaseTimer", "enable_compilation_cache"]


def enable_compilation_cache(directory=None, min_compile_secs=0.5):
    """Turn on JAX's persistent compilation cache.

    On remote-compile environments first compiles cost tens of seconds;
    caching them (keyed by HLO hash, safe across code changes) makes repeat
    processes start ~3x faster.  Default directory: ``~/.cache/pmg_jax``."""
    import os

    import jax

    if directory is None:
        directory = os.path.join(
            os.path.expanduser("~"), ".cache", "pmg_jax"
        )
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return directory


@contextlib.contextmanager
def trace(log_dir, host_tracer_level=2):
    """Capture a jax.profiler device trace into ``log_dir`` (viewable with
    tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir, host_tracer_level=host_tracer_level)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulate wall-clock times per named phase.

    with timer("e_step"): ...   # blocks on the phase's outputs if sync=True
    """

    def __init__(self, sync=True):
        self.sync = sync
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time()
        yield
        if self.sync:
            import jax

            # wait for everything dispatched so far
            (jax.device_put(0.0) + 0).block_until_ready()
        self.times.setdefault(name, []).append(time.time() - t0)

    def summary(self):
        return {
            k: {"total": sum(v), "mean": sum(v) / len(v), "n": len(v)}
            for k, v in self.times.items()
        }
