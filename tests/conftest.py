"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices, so the
sharding tests run without accelerators.  ``PMG_GPU_TESTS=1`` leaves the
platform alone instead: that is how the tests marked ``gpu`` are run on a
card (``PMG_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu``); without it they
skip.

The CPU platform is set in JAX's config after import (before any backend
is initialized) as well as in the environment, so it holds even where a
platform plugin registers itself regardless of ``JAX_PLATFORMS``.
"""

import os

ON_GPU = os.environ.get("PMG_GPU_TESTS") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from poor_man_gplvm_tpu.utils.compile_cache import (  # noqa: E402
    compile_cache_dir,
)

# persistent XLA compilation cache: $JAX_COMPILATION_CACHE_DIR when set,
# else one fixed directory in the checkout (listed in .gitignore)
_cache_dir = compile_cache_dir(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache_tests")
)
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

# export as env vars too so subprocess-spawning tests (the __graft_entry__
# multichip dryrun child, the cold-start example smoke) inherit the same
# cache — jax reads these at import time in the child
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache_dir)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.3")


@pytest.fixture
def gpu():
    """Skip unless the default device is an NVIDIA GPU.  Decided here, at
    test time, never while modules are imported or collected."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}); run "
                    "with PMG_GPU_TESTS=1 on a card")
    return dev
