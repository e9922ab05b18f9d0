"""Inference-engine resolution and the device memory policy.

Every choice of smoother engine goes through :func:`resolve_engine`, and
every memory threshold is a fraction of :func:`device_memory_budget`, so
the platform is tested in exactly one place.

Engines:

* ``'prob'`` -- scaled probability-space ``lax.scan`` (ops/hmm.py); the
  sequential reference every other engine is tested against.
* ``'log'`` -- log-space mirror of the reference's operation order.
* ``'pallas'`` -- the sequential filter/smoother as one Pallas kernel
  through Triton (ops/pallas/scan_kernels.py): one program per sequence,
  the time loop inside the kernel, the transition held in registers.
  Compiled for the GPU only, and only for ``n_latent <= KERNEL_MAX_L``.
* ``'pallas_interpret'`` -- the same kernel run by the Pallas interpreter
  on any platform; it exists for tests and is never chosen automatically.
* ``'pallas_parallel'`` -- the fixed-point parallel-in-time smoother
  (ops/pallas/parallel_scan.py): C chunks of the sequence advance together
  as one batched matmul per step.
* ``'auto'`` -- ``'prob'`` off the GPU.  On the GPU: the sequential kernel
  for sequences shorter than ``PARALLEL_MIN_T`` when ``n_latent <=
  KERNEL_MAX_L``; otherwise ``'pallas_parallel'`` wherever the sequence is
  long enough to chunk and its full-sequence buffers fit the parallel
  budget; else the sequential kernel where ``n_latent`` allows it, and
  ``'prob'`` last.

The thresholds come from ``scripts/measure_engines.py`` on an H100 (PERF.md):
``decode_latent`` at L=100 is fastest with the kernel up to T=2k and with
the parallel engine from T=5k on, and without the kernel (L=500) the
parallel engine beats ``'prob'`` at every T it can chunk.
"""

from __future__ import annotations

import jax

ENGINES = ("auto", "prob", "log", "pallas", "pallas_interpret",
           "pallas_parallel")

#: Largest latent size the sequential kernel is built for: its (L, L)
#: transition block must stay in one program's registers.
KERNEL_MAX_L = 128

#: 'auto' switches a GPU run from the sequential kernel to the fixed-point
#: parallel engine at this many time steps (measured crossover, PERF.md).
PARALLEL_MIN_T = 5_000

#: The memory thresholds below are fractions of the device budget.  They
#: keep the ratios the library was first tuned with on a 16 GB device.
PARALLEL_BUDGET_FRAC = 12 / 16   # parallel engine's full-sequence buffers
FULL_MODE_FRAC = 4 / 16          # memory_mode 'auto' -> 'full'
FILTER_STORE_FRAC = 2 / 16       # memory_mode 'auto' -> 'filter'
CHUNK_WORKSET_FRAC = 2 / 16      # auto_chunk_size's per-chunk working set

#: Host-memory stand-in used on the CPU, whose devices report no limit.
CPU_BUDGET_BYTES = 8e9


def device_memory_budget(device=None):
    """The device's memory limit in bytes (``memory_stats()['bytes_limit']``).

    The CPU backend reports no limit, so there the budget is the fixed
    host value ``CPU_BUDGET_BYTES``.  On an accelerator a missing limit is
    an error: a guessed budget would size every threshold wrongly."""
    device = jax.local_devices()[0] if device is None else device
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return float(limit)
    if device.platform == "cpu":
        return CPU_BUDGET_BYTES
    raise RuntimeError(
        f"device {device.device_kind!r} ({device.platform}) reports no "
        "bytes_limit in memory_stats(); cannot size the memory policy"
    )


def parallel_fits(n_time, n_latent, n_dyn, budget=None):
    """Whether the parallel engine's full-sequence buffers (likelihood
    weights plus f32 filter posteriors and outputs, ~4*T*L*(1+2*n_dyn)
    bytes) fit ``PARALLEL_BUDGET_FRAC`` of the device budget.  The parallel
    engine has no O(chunk) mode, so 'auto' keeps longer sequences on the
    chunked sequential engines."""
    budget = device_memory_budget() if budget is None else budget
    est_bytes = 4.0 * n_time * n_latent * (1 + 2 * max(1, n_dyn))
    return est_bytes <= PARALLEL_BUDGET_FRAC * budget


def check_engine(engine):
    if engine not in ENGINES:
        raise ValueError(
            f"unknown inference engine {engine!r}; one of {ENGINES}"
        )
    return engine


def sequential_engine(n_latent, on=None):
    """The platform's sequential engine for this latent size."""
    on = jax.default_backend() if on is None else on
    if on == "gpu" and n_latent <= KERNEL_MAX_L:
        return "pallas"
    return "prob"


def resolve_engine(engine, n_time, n_latent, n_dyn=1, on=None,
                   budget=None):
    """Map a requested engine to the one that runs (see module docstring).

    ``on`` is the platform name (default: JAX's default backend)."""
    check_engine(engine)
    on = jax.default_backend() if on is None else on
    if engine == "pallas":
        if on != "gpu":
            raise ValueError(
                f"engine 'pallas' is a GPU kernel and the platform is {on!r}"
                "; use 'prob', 'auto' or 'pallas_parallel' (tests run the "
                "kernel's interpreter with 'pallas_interpret')"
            )
        if n_latent > KERNEL_MAX_L:
            raise ValueError(
                f"engine 'pallas' is built for n_latent <= {KERNEL_MAX_L} "
                f"(got {n_latent}); use 'auto', 'prob' or 'pallas_parallel'"
            )
        return engine
    if engine != "auto":
        return engine
    if on != "gpu":
        return "prob"
    kernel = n_latent <= KERNEL_MAX_L
    if kernel and n_time < PARALLEL_MIN_T:
        return "pallas"
    from poor_man_gplvm_tpu.ops.pallas.parallel_scan import (
        choose_parallel_config,
    )

    if (
        choose_parallel_config(n_time, n_latent, n_dyn) is not None
        and parallel_fits(n_time, n_latent, n_dyn, budget)
    ):
        return "pallas_parallel"
    return sequential_engine(n_latent, on)
