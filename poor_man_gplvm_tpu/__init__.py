"""poor_man_gplvm_tpu — GPLVM/JumpLVM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``poor-man-GPLVM`` (GPLVM with a discretized 1-D latent and a 2-state
continuous-vs-jump dynamics HMM for binned neural spike counts):
matmul-form emission likelihoods, scaled probability-space
forward-backward scans (sequential, as Pallas kernels, or
parallel-in-time), device-mesh sharding via ``shard_map``.

Public model classes mirror the reference API
(reference poor_man_gplvm/__init__.py:6-12):
``PoissonGPLVMJump1D`` (flagship), ``GaussianGPLVMJump1D``,
``PoissonGPLVM1D``, ``GaussianGPLVM1D`` and the two abstract bases.

The reference-compatible submodule surface (``analysis``, ``plot_helper``,
``selection``, ...) loads on first attribute access, so the model/ops path
imports with numpy, scipy, optax and JAX alone; pandas and matplotlib are
needed only by the analysis, plotting, data and selection modules that use
them.
"""

import importlib

from poor_man_gplvm_tpu.models.jump1d import (
    AbstractGPLVMJump1D,
    PoissonGPLVMJump1D,
    GaussianGPLVMJump1D,
)
from poor_man_gplvm_tpu.models.latent1d import (
    AbstractGPLVM1D,
    PoissonGPLVM1D,
    GaussianGPLVM1D,
)
from poor_man_gplvm_tpu.ops.basis import generate_basis

from poor_man_gplvm_tpu.config import (
    get_matmul_precision,
    set_matmul_precision,
)

# reference-compatible submodule surface (poor_man_gplvm/__init__.py:6-12),
# imported on first access
_LAZY_SUBMODULES = (
    "analysis",
    "analysis_helper",
    "core",
    "data",
    "decoder",
    "decoder_latentonly",
    "distance_analysis",
    "experimental",
    "fit_tuning_helper",
    "gp_kernel",
    "initializer",
    "jump_analysis",
    "model_selection_helper",
    "pandas_util",
    "parallel",
    "plot_helper",
    "reactivation_analysis",
    "selection",
    "test",
    "trial_analysis",
    "utils",
    "validation",
    "verify_latent_jump",
    "workflows",
)


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_SUBMODULES))


__version__ = "0.1.0"

__all__ = [
    "AbstractGPLVM1D",
    "AbstractGPLVMJump1D",
    "PoissonGPLVM1D",
    "GaussianGPLVM1D",
    "PoissonGPLVMJump1D",
    "GaussianGPLVMJump1D",
    "generate_basis",
    "set_matmul_precision",
    "get_matmul_precision",
]
