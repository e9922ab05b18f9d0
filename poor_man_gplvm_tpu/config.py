"""Runtime configuration knobs.

The reference has no config system beyond ctor kwargs and per-call
``hyperparam`` dicts (SURVEY §5); those are preserved on the model
classes.  This module adds deployment knobs that have no reference
counterpart.
"""

from __future__ import annotations

import importlib

import jax

__all__ = ["set_matmul_precision", "get_matmul_precision"]

#: Modules whose ``PRECISION`` global controls the emission / M-step
#: statistics matmuls (the large (T, L) x (L, N) contractions).  The HMM
#: scan-step products (ops/hmm.py, ops/pallas/*) are deliberately NOT on
#: this list: they carry the <=1e-5 reference-parity guarantee and stay
#: f32-exact.
_PRECISION_MODULES = (
    "poor_man_gplvm_tpu.ops.emissions",
    "poor_man_gplvm_tpu.ops.mstep",
    "poor_man_gplvm_tpu.ops.fit_tuning_with_basis",
    "poor_man_gplvm_tpu.experimental.fit_tuning_helper_exp",
    "poor_man_gplvm_tpu.experimental.gain",
)

_LEVELS = {
    "highest": jax.lax.Precision.HIGHEST,
    "float32": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "bfloat16_3x": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
    "bfloat16": jax.lax.Precision.DEFAULT,
}


def set_matmul_precision(level):
    """Set the precision of the emission / M-step statistics matmuls.

    ``'highest'`` (the default) is f32-exact on every backend.  What the
    lower levels mean depends on the backend's lowering of
    ``jax.lax.Precision``.  Measured on an NVIDIA H100 for a
    (200000, 500) @ (500, 500) f32 product (PERF.md):

    ==========  ===========  =========================
    level       TFLOP/s      max error / max |result|
    ==========  ===========  =========================
    'highest'   40.8         1.2e-6 (f32; the default)
    'high'      94.7         3.1e-4 (TF32)
    'default'   91.5         3.0e-4 (TF32)
    ==========  ===========  =========================

    So on that card ``'high'`` and ``'default'`` both lower to TF32
    tensor-core products, outside the 1e-5 log-marginal parity envelope
    for large N.  The scan-step recursions stay f32-exact regardless (see
    ``_PRECISION_MODULES``).

    Call before building models/fitting.  Already-compiled programs are
    dropped (``jax.clear_caches``); per-model fused-program caches are
    keyed only by static config, so rebuild models created earlier.
    """
    level_l = str(level).lower()
    if level_l not in _LEVELS:
        raise ValueError(
            f"unknown precision {level!r}; one of {sorted(_LEVELS)}"
        )
    p = _LEVELS[level_l]
    for name in _PRECISION_MODULES:
        mod = importlib.import_module(name)
        mod.PRECISION = p
    jax.clear_caches()
    return p


def get_matmul_precision():
    """The currently-active emission/M-step matmul precision."""
    from poor_man_gplvm_tpu.ops import emissions

    return emissions.PRECISION
