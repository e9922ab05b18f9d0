"""Post-fit neuron sorting + numpy helper kernels.

Equivalent of reference poor_man_gplvm/utils.py.  NOTE: the
reference README calls this function ``post_fit_sort_neurons`` (plural) but
defines ``post_fit_sort_neuron`` — we keep the defined name and add the
plural as an alias (reference README.md:162 vs utils.py:43, a stale doc).
"""

from __future__ import annotations

import numpy as np

from poor_man_gplvm_tpu.utils import compat

__all__ = ["rbf_kernel", "post_fit_sort_neuron", "post_fit_sort_neurons", "pca_init"]


def rbf_kernel(X, Y=None, length_scale=1.0):
    """numpy RBF Gram matrix.  NOTE different convention from the jax kernel
    layer: ``exp(-0.5 d^2 / ls^2)`` (reference utils.py:6-39 keeps the 1/2
    factor here but not in gp_kernel.rbf_kernel — preserved as-is)."""
    X = np.asarray(X)
    Y = X if Y is None else np.asarray(Y)
    XX = np.sum(X**2, axis=1)[:, np.newaxis]
    YY = np.sum(Y**2, axis=1)[np.newaxis, :]
    XY = np.dot(X, Y.T)
    sq_dists = XX + YY - 2 * XY
    return np.exp(-0.5 * sq_dists / (length_scale**2))


def post_fit_sort_neuron(fit_res, spk=None, do_norm="max",
                         method="tuning_peak", t_l=None):
    """Argsort neurons by tuning-peak location; optionally normalize + sort
    the spike matrix for raster plots (reference utils.py:43-78)."""
    if method == "tuning_peak":
        assert "tuning" in fit_res, "Tuning is not in the fit result"
        tuning = np.asarray(fit_res["tuning"])
        argsort = np.argsort(np.argmax(tuning, axis=0))
    else:
        raise ValueError(f"Invalid method: {method}")

    to_return = {}
    if spk is not None:
        spk = np.asarray(spk)
        if do_norm == "max":
            spk_to_plot = spk / spk.max(axis=0, keepdims=True)
        elif do_norm == "zscore":
            spk_to_plot = (spk - spk.mean(axis=0, keepdims=True)) / spk.std(
                axis=0, keepdims=True
            )
        elif do_norm is None:
            spk_to_plot = spk
        else:
            raise ValueError(f"Invalid normalization method: {do_norm}")
        spk_no_sort = spk_to_plot
        spk_to_plot = spk_to_plot[:, argsort]
        if t_l is not None:
            spk_to_plot = compat.tsdframe(d=spk_to_plot, t=t_l)
            spk_no_sort = compat.tsdframe(d=spk_no_sort, t=t_l)
        to_return["spk_to_plot"] = spk_to_plot
        to_return["spk_no_sort"] = spk_no_sort

    to_return["argsort"] = argsort
    return to_return


# alias for the README's (stale) plural spelling
post_fit_sort_neurons = post_fit_sort_neuron


def pca_init(Y, latent_dim):
    """PCA latent init in numpy (reference utils.py:83-110; kept for parity,
    noted there as 'tested so far not good; not used')."""
    Y = np.asarray(Y)
    Y_centered = Y - np.mean(Y, axis=0)
    U, S, _ = np.linalg.svd(Y_centered, full_matrices=False)
    return U[:, :latent_dim] * S[:latent_dim]
