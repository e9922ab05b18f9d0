"""Hyperparameter selection: the reference-style serial sweep and the
Batched sweep (one compiled program for the whole grid)."""
import numpy as np
import jax.random as jr
import poor_man_gplvm_tpu as pmg
from poor_man_gplvm_tpu import selection
from poor_man_gplvm_tpu.parallel import sweep

gen = pmg.PoissonGPLVMJump1D(15, n_latent_bin=20, tuning_lengthscale=3.0)
_, y = gen.sample(400, key=jr.PRNGKey(0))
y = np.asarray(y)

# reference-style: fit/evaluate each config serially with held-out metrics
fit_kwargs = dict(selection.default_fit_kwargs, n_iter=3, verboase=False)
res = selection.model_selection_one_split(
    y, {"movement_variance": [0.5, 2.0]}, fit_kwargs=fit_kwargs,
    n_repeat=2, latent_downsample_frac=[0.5], downsample_n_repeat=3,
    verbose=False,
)
print("best config (serial):", res["best_config"])
print(res["model_eval_result_all_configs"][
    ["movement_variance", "metric_overall_best_value"]])

# batched: whole (config x chain) grid in ONE vmapped program
batched = sweep.sweep_fit_poisson_jump(
    y, {"movement_variance": [0.5, 2.0]}, n_repeat=2, n_iter=3,
    n_latent_bin=20, tuning_lengthscale=3.0, m_maxiter=50,
)
lml = np.asarray(batched["log_marginal_l"])[:, -1]
print("batched final lml per run:", np.round(lml, 1))
