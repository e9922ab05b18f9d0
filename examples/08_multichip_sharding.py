"""Multi-chip SPMD EM on a device mesh (runs on 8 virtual CPU devices when
fewer than 8 accelerators are attached)."""
import os
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax
# demo runs on 8 virtual CPU devices (must force before backend init)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import optax
from poor_man_gplvm_tpu.ops import hmm, kernels as gpk
from poor_man_gplvm_tpu.parallel import spmd

mesh = spmd.make_mesh(8, batch=2)
print("mesh:", dict(mesh.shape))

B, T, N, L, RANK = 2, 64, 8, 10, 4
rng = np.random.default_rng(0)
y = jnp.asarray(rng.poisson(1.0, (B, T, N)), dtype=jnp.float32)
basis = jnp.asarray(rng.normal(size=(L, RANK)), dtype=jnp.float32)
params = jnp.asarray(rng.normal(size=(B, RANK, N)) * 0.3, dtype=jnp.float32)
log_post = jnp.log(jnp.ones((B, T, L)) / L)
lat_l, log_lat_l, dyn, log_dyn = gpk.create_transition_prob_1d(
    jnp.arange(L), jnp.arange(2), 1.0, 0.01, 0.01)
trans = hmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)
opt_state = jax.vmap(optax.adam(0.01).init)(params)

step = spmd.make_sharded_poisson_em_step(mesh, basis, trans, m_maxiter=20)
for i in range(3):
    params, opt_state, log_post, lml, loss = step(params, opt_state, log_post, y)
    print(f"EM iter {i}: lml per chain = {np.round(np.asarray(lml), 1)}")

# -- single-sequence sharded smoother: cross-mesh fixed-point scans --------
# every device advances its local chunks simultaneously; boundary carries
# ride one ppermute per pass ('pscan', the default for single sequences);
# 'pipeline' is the staged hand-off schedule used for many-chain batches
y1 = jnp.asarray(rng.poisson(1.0, (601, N)), dtype=jnp.float32)
tuning = jnp.exp(jnp.asarray(rng.normal(size=(L, N)) * 0.2))
for time_engine in ("pscan", "pipeline"):
    out = spmd.sharded_smooth(
        mesh, y1, tuning, {}, trans, jnp.ones(N), jnp.ones(L),
        time_engine=time_engine,
    )
    print(f"sharded_smooth[{time_engine}]: log_marginal = {float(out[1]):.2f}")
