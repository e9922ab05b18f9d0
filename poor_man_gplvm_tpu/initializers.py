"""Latent-posterior initializers: PCA-based and supervised-label-based.

Equivalent of reference poor_man_gplvm/initializer.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pandas as pd
from jax.scipy.special import logsumexp

from poor_man_gplvm_tpu.utils import compat

__all__ = ["init_with_pca", "init_with_label_1D"]


def init_with_pca(y, n_latent_bin, n_pca_components=None, noise_scale=0,
                  key=None, **kwargs):
    """PCA projection -> row-normalize -> log-softmax over latent bins
    (reference initializer.py:11-36).  Preserves time-to-time correlation in
    the init."""
    from sklearn.decomposition import PCA

    key = jr.PRNGKey(0) if key is None else key
    assert n_latent_bin < y.shape[1], (
        "n_latent_bin should be less than n_neuron"
    )
    if n_pca_components is None:
        n_pca_components = n_latent_bin
    pca = PCA(n_components=n_pca_components)
    pca.fit(y)
    pca_latent = jnp.asarray(pca.transform(y))
    if noise_scale > 0:
        pca_latent = pca_latent + jr.normal(key, shape=pca_latent.shape) * noise_scale
    pca_latent_norm = pca_latent / jnp.linalg.norm(
        pca_latent, axis=1, keepdims=True
    )
    return pca_latent_norm - logsumexp(pca_latent_norm, axis=1, keepdims=True)


def init_with_label_1D(label_tsd, n_latent_bin=100, t_l=None, seed=0,
                       noise_scale=1e-3):
    """Supervised init: bin a behavioral label, set its latent bin's
    probability to ~1, uniform elsewhere, plus noise
    (reference initializer.py:40-86).

    ``label_tsd``: Tsd (pynapple or internal shim) of label values; assumed
    contiguous in time.  If ``t_l`` covers more time than the label, bins
    outside the label's support are initialized uniform."""
    rng = np.random.default_rng(seed)
    if compat.HAS_PYNAPPLE:
        import pynapple as nap
    else:
        from poor_man_gplvm_tpu.utils import timeseries as nap

    if t_l is not None:
        T = len(t_l)
        if isinstance(t_l, np.ndarray):
            t_l = nap.Ts(t_l)
        label_aligned = t_l.value_from(label_tsd)
        label_binned, _bins = pd.cut(
            np.asarray(label_aligned.d), bins=n_latent_bin, retbins=True,
            labels=False,
        )
        posterior = np.ones((T, n_latent_bin)) / n_latent_bin

        sl = t_l.get_slice(
            label_tsd.time_support.start[0], label_tsd.time_support.end[0]
        )
        sl = np.arange(sl.start, sl.stop, sl.step or 1)
        posterior[sl, :] = 0.0
        posterior[sl, label_binned] = 1.0
        posterior = posterior + rng.random(posterior.shape) * noise_scale
        posterior = posterior / posterior.sum(axis=1, keepdims=True)
        log_p_latent = np.where(posterior > 0, np.log(posterior), -1e20)
    else:
        T = len(label_tsd)
        label_binned, _bins = pd.cut(
            np.asarray(label_tsd), bins=n_latent_bin, retbins=True, labels=False
        )
        posterior = np.zeros((T, n_latent_bin))
        posterior[np.arange(T), label_binned] = 1.0
        posterior = posterior + rng.random(posterior.shape) * noise_scale
        posterior = posterior / posterior.sum(axis=1, keepdims=True)
        log_p_latent = np.where(posterior > 0, np.log(posterior), -1e20)
    return log_p_latent
