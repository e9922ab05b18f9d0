"""Tuning-curve basis generation.

Equivalent of the reference's ``generate_basis``
(reference: poor_man_gplvm/core.py:41-73): SVD of the (L, L) RBF Gram
matrix, keep the leading ``n_basis`` singular vectors scaled by the fourth
root of the singular values, prepend a bias column.

``n_basis`` is data-dependent (cumulative-explained-variance rule), so it is
computed *host-side* at model-construction time — all downstream jitted
programs then see static shapes (SURVEY.md §7.2 step 1).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from poor_man_gplvm_tpu.ops.kernels import rbf_gram

__all__ = ["generate_basis"]


def _bspline_design(n_points, n_basis, order=4):
    """(n_points, n_basis) cubic-by-default B-spline design matrix on a
    uniform grid over [0, 1] with clamped (repeated-boundary) knots — the
    scipy equivalent of the nemos ``BSplineEval(n_basis)
    .evaluate_on_grid(n_points)`` call the reference left commented out
    (reference core.py:57-59)."""
    from scipy.interpolate import BSpline

    if n_basis < order:
        raise ValueError(
            f"bspline basis needs n_basis >= order ({order}); got {n_basis}"
        )
    degree = order - 1
    n_interior = n_basis - order
    interior = (
        np.linspace(0.0, 1.0, n_interior + 2)[1:-1]
        if n_interior > 0 else np.empty(0)
    )
    knots = np.concatenate(
        [np.zeros(order), interior, np.ones(order)]
    )
    x = np.linspace(0.0, 1.0 - 1e-9, n_points)  # keep last point in-span
    return np.asarray(
        BSpline.design_matrix(x, knots, degree).toarray(), dtype=np.float32
    )


def generate_basis(
    lengthscale,
    n_latent_bin,
    explained_variance_threshold_basis=0.999,
    include_bias=True,
    basis_type="rbf",
    custom_kernel=None,
    n_basis_bspline=None,
):
    """Build the (L, n_basis[+1]) tuning basis.

    Rank rule (reference core.py:54): ``n_basis = (cumsum(s / s.sum()) <
    thresh).sum() + 1`` — the first index whose cumulative share crosses the
    threshold.  Columns scaled by ``s**0.25`` (the *fourth* root,
    reference core.py:55-56).

    ``basis_type='bspline'``: clamped cubic B-splines on the latent grid
    (``n_basis_bspline`` functions, default ``max(4, L // 3)``) — the
    branch the reference commented out (core.py:57-59) yet still selects
    its smoothness-penalized M-step objective for; implemented here so
    ``smoothness_penalty`` is reachable.
    """
    if custom_kernel is not None:
        basis_type = "custom_kernel"

    if basis_type == "bspline":
        nb = (
            int(n_basis_bspline) if n_basis_bspline is not None
            else max(4, n_latent_bin // 3)
        )
        tuning_basis = jnp.asarray(_bspline_design(n_latent_bin, nb))
        if include_bias:
            tuning_basis = jnp.concatenate(
                [jnp.ones((n_latent_bin, 1), dtype=tuning_basis.dtype),
                 tuning_basis], axis=1,
            )
        return tuning_basis

    if basis_type == "rbf":
        possible_latent_bin = jnp.arange(n_latent_bin)
        gram, _ = rbf_gram(possible_latent_bin, lengthscale, 1.0)
    elif basis_type == "custom_kernel":
        if custom_kernel is None:
            raise ValueError(
                "custom_kernel must be provided when basis_type is custom_kernel"
            )
        gram = jnp.asarray(custom_kernel)
    else:
        raise ValueError(f"Unsupported basis_type: {basis_type!r}")

    tuning_basis, sing_val, _ = jnp.linalg.svd(gram)
    # host-side, concrete: keeps downstream shapes static
    sing_val_np = np.asarray(sing_val)
    n_basis = int((np.cumsum(sing_val_np / sing_val_np.sum()) <
                   explained_variance_threshold_basis).sum()) + 1
    quarter_root = jnp.sqrt(jnp.sqrt(sing_val[:n_basis]))
    tuning_basis = tuning_basis[:, :n_basis] * quarter_root[None, :]

    if include_bias:
        n_rows = tuning_basis.shape[0]
        tuning_basis = jnp.concatenate(
            [jnp.ones((n_rows, 1), dtype=tuning_basis.dtype), tuning_basis], axis=1
        )
    return tuning_basis
