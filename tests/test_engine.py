"""Engine resolution, the memory policy, the compile-cache location, the
package's import surface and chip_smoke.py's refusal to run off the GPU —
all decided on the CPU with the platform passed in explicitly."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from poor_man_gplvm_tpu.ops import engine as eng
from poor_man_gplvm_tpu.ops import hmm
from poor_man_gplvm_tpu.ops.pallas import parallel_scan as ps
from poor_man_gplvm_tpu.ops.pallas import scan_kernels as sk
from poor_man_gplvm_tpu.utils.compile_cache import compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 16e9


@pytest.mark.parametrize("engine", ["prob", "log", "pallas_parallel",
                                    "pallas_interpret"])
@pytest.mark.parametrize("on", ["cpu", "gpu"])
def test_explicit_engines_pass_through(engine, on):
    assert eng.resolve_engine(engine, 50_000, 100, 2, on=on,
                              budget=BUDGET) == engine


@pytest.mark.parametrize("T", [10, 5_000, 50_000, 1_000_000])
@pytest.mark.parametrize("L", [30, 100, 500])
def test_auto_resolution_per_platform_and_T(T, L):
    assert eng.resolve_engine("auto", T, L, 2, on="cpu",
                              budget=BUDGET) == "prob"
    got = eng.resolve_engine("auto", T, L, 2, on="gpu", budget=BUDGET)
    chunkable = ps.choose_parallel_config(T, L, 2) is not None
    if L <= eng.KERNEL_MAX_L:
        want = ("pallas_parallel" if T >= eng.PARALLEL_MIN_T and chunkable
                else "pallas")
    else:
        want = "pallas_parallel" if chunkable else "prob"
    assert got == want
    # never the interpreter, whatever the shape
    assert got != "pallas_interpret"


def test_pallas_engine_needs_a_gpu_and_small_L():
    with pytest.raises(ValueError, match="GPU kernel"):
        eng.resolve_engine("pallas", 1_000, 100, 2, on="cpu")
    with pytest.raises(ValueError, match="n_latent"):
        eng.resolve_engine("pallas", 1_000, eng.KERNEL_MAX_L + 1, 2,
                           on="gpu")
    assert eng.resolve_engine("pallas", 1_000, eng.KERNEL_MAX_L, 2,
                              on="gpu") == "pallas"
    with pytest.raises(ValueError, match="unknown inference engine"):
        eng.resolve_engine("mosaic", 1_000, 100, 2, on="gpu")


def test_pallas_on_cpu_raises_at_the_smoother():
    """An explicit 'pallas' request on the CPU fails loudly instead of
    silently running the interpreter."""
    rng = np.random.default_rng(0)
    L, N = 6, 4
    y = rng.poisson(1.0, size=(40, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    T_mat = np.full((L, L), 1.0 / L, np.float32)
    trans = hmm.LatentTransition(T_mat, np.log(T_mat))
    with pytest.raises(ValueError, match="pallas_interpret"):
        hmm.smooth_combined_chunked(y, tuning, {}, trans, np.ones(N),
                                    np.ones(L), engine="pallas")


def _dev(platform, stats):
    return types.SimpleNamespace(
        platform=platform, device_kind=f"fake {platform}",
        memory_stats=lambda: stats,
    )


def test_device_memory_budget_reads_the_card():
    assert eng.device_memory_budget(_dev("gpu", {"bytes_limit": 6e10})) \
        == 6e10
    assert eng.device_memory_budget(_dev("cpu", None)) == \
        eng.CPU_BUDGET_BYTES
    with pytest.raises(RuntimeError, match="bytes_limit"):
        eng.device_memory_budget(_dev("gpu", {}))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        eng.device_memory_budget(_dev("gpu", None))


@pytest.mark.parametrize("budget", [16e9, 64e9])
def test_memory_thresholds_are_fractions_of_the_budget(budget):
    state, L = 2 * 500, 500
    per_t = (3 * state + L) * 4
    t_full = int(eng.FULL_MODE_FRAC * budget // per_t)
    assert hmm.auto_memory_mode(t_full, state, L, budget) == "full"
    assert hmm.auto_memory_mode(t_full + 1, state, L, budget) == "filter"
    t_store = int(eng.FILTER_STORE_FRAC * budget // (state * 4))
    assert hmm.auto_memory_mode(t_store, state, L, budget) == "filter"
    assert hmm.auto_memory_mode(t_store + 1, state, L, budget) == \
        "checkpoint"
    assert hmm.auto_chunk_size(t_full, state, L, budget) == t_full
    chunk = hmm.auto_chunk_size(100 * t_full, state, L, budget)
    assert chunk == int(eng.CHUNK_WORKSET_FRAC * budget // per_t)
    t_par = int(eng.PARALLEL_BUDGET_FRAC * budget // (4 * L * 5))
    assert eng.parallel_fits(t_par, L, 2, budget)
    assert not eng.parallel_fits(t_par + 1, L, 2, budget)


def test_kernel_latent_padding_is_a_power_of_two():
    assert [sk._pow2(x) for x in (1, 5, 16, 17, 100, 128, 130, 500)] == \
        [16, 16, 16, 32, 128, 128, 256, 512]


def test_compile_cache_dir_honours_the_environment(monkeypatch, tmp_path):
    fixed = str(tmp_path / "fixed")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir(fixed) == fixed
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache_dir(fixed) == str(tmp_path / "env")


def _run(code, cwd=REPO, timeout=600, extra_env=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    return subprocess.run([sys.executable, *code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_and_fit_without_optional_packages():
    """The package and its main path import and fit with tqdm, pandas and
    matplotlib unavailable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('tqdm', 'pandas', 'matplotlib'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import jax.random as jr, numpy as np\n"
        "import poor_man_gplvm_tpu as pmg\n"
        "import poor_man_gplvm_tpu.parallel, poor_man_gplvm_tpu.validation\n"
        "m = pmg.PoissonGPLVMJump1D(5, n_latent_bin=8, tuning_lengthscale=3.)\n"
        "_, y = m.sample(60, key=jr.PRNGKey(0))\n"
        "em = m.fit_em(y, key=jr.PRNGKey(1), n_iter=2, verboase=True)\n"
        "d = m.decode_latent(y)\n"
        "assert np.isfinite(d['log_marginal_final'])\n"
        "assert 'pandas' not in sys.modules and 'tqdm' not in sys.modules\n"
        "print('IMPORT_OK')\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORT_OK" in proc.stdout


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no ok line on the CPU, both
    in the checkout and alone in an empty directory."""
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (str(tmp_path), os.path.join(REPO, "chip_smoke.py"))):
        if cwd != REPO:
            import shutil

            shutil.copy(script, tmp_path / "chip_smoke.py")
            script = "chip_smoke.py"
        proc = _run([script], cwd=cwd, timeout=300,
                    extra_env={"PYTHONPATH": ""} if cwd != REPO else None)
        assert proc.returncode != 0, proc.stdout[-2000:]
        assert '"ok": true' not in proc.stdout
