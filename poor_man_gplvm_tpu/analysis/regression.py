"""Pre/post-event regression with interaction.

Equivalent of reference analysis_helper.py:206-341
(``fit_time_prepost_interaction``): OLS of ``y ~ time_within * C(is_post)``
with time z-scored within the pre/post sides, cluster-robust (by repeat) or
HC1 standard errors.  Uses the internal OLS (statsmodels-free).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from poor_man_gplvm_tpu.utils.stats import ols_fit

__all__ = ["fit_time_prepost_interaction"]


def fit_time_prepost_interaction(
    df_wide, time=None, repeat_name="repeat", response_name="y", cov="cluster",
):
    """Fit ``response ~ time_within * C(is_post)``.

    df_wide: (n_repeat, n_time) DataFrame; columns are times (or pass
    ``time``).  time_within is z-scored separately within pre (<0) and post
    (>=0).  Returns the reference's result dict: summary_df with
    slope/intercept pre/post/diff rows, params, bse, pvalues, conf_int,
    rsquared(_adj), f_pvalue, nobs, cov_type, coef_pre/post, p_interaction,
    p_intercept_diff, model, data_long."""
    wide = df_wide.copy()
    if time is None:
        try:
            t = pd.to_numeric(wide.columns, errors="raise").astype(float)
        except Exception as e:
            raise ValueError(
                "Cannot parse df_wide.columns as numeric times; pass `time` "
                "explicitly."
            ) from e
    else:
        t = np.asarray(time, dtype=float)
        if len(t) != wide.shape[1]:
            raise ValueError(
                "`time` length must match number of columns in df_wide."
            )

    wide.columns = t
    long = (
        wide.rename_axis(index=repeat_name, columns="time")
        .stack()
        .reset_index(name=response_name)
    )
    if not ((long["time"] < 0).any() and (long["time"] >= 0).any()):
        raise ValueError(
            "Time grid must include both pre (<0) and post (>=0) samples."
        )

    long["is_post"] = (long["time"] >= 0).astype(int)

    def _z_by_side(x):
        s = x.std(ddof=0)
        return (x - x.mean()) / s if s > 0 else x * 0.0

    long["time_within"] = long.groupby("is_post")["time"].transform(_z_by_side)

    # design: [1, time_within, is_post, time_within*is_post]
    y = long[response_name].to_numpy(dtype=float)
    tw = long["time_within"].to_numpy(dtype=float)
    ip = long["is_post"].to_numpy(dtype=float)
    X = np.column_stack([np.ones(len(y)), tw, ip, tw * ip])
    names = ["Intercept", "time_within", "C(is_post)[T.1]",
             "time_within:C(is_post)[T.1]"]

    if cov == "cluster":
        res = ols_fit(X, y, cov_type="cluster",
                      groups=long[repeat_name].to_numpy(), param_names=names)
    elif cov == "HC1":
        res = ols_fit(X, y, cov_type="HC1", param_names=names)
    else:
        raise ValueError("cov must be 'cluster' or 'HC1'.")

    c_slope_pre = np.array([0, 1, 0, 0])
    c_slope_post = np.array([0, 1, 0, 1])
    c_slope_diff = np.array([0, 0, 0, 1])
    c_int_pre = np.array([1, 0, 0, 0])
    c_int_post = np.array([1, 0, 1, 0])
    c_int_diff = np.array([0, 0, 1, 0])

    summary_df = pd.DataFrame.from_dict(
        {
            "slope_pre": res.t_test(c_slope_pre),
            "slope_post": res.t_test(c_slope_post),
            "slope_diff": res.t_test(c_slope_diff),
            "intercept_pre": res.t_test(c_int_pre),
            "intercept_post": res.t_test(c_int_post),
            "intercept_diff": res.t_test(c_int_diff),
        },
        orient="index",
    )

    ci_full = pd.DataFrame(res.conf_int(), index=names, columns=["low", "high"])
    params = pd.Series(res.params, index=names)
    beta0, beta1, beta2, beta3 = res.params

    coef_pre = {
        "intercept": beta0, "slope": beta1,
        "p_slope": summary_df.loc["slope_pre", "pvalue"],
    }
    coef_post = {
        "intercept": beta0 + beta2, "slope": beta1 + beta3,
        "p_slope": summary_df.loc["slope_post", "pvalue"],
    }

    return {
        "summary_df": summary_df,
        "params": params,
        "bse": pd.Series(res.bse, index=names),
        "pvalues": pd.Series(res.pvalues, index=names),
        "conf_int": ci_full,
        "rsquared": res.rsquared,
        "rsquared_adj": res.rsquared_adj,
        "f_pvalue": res.f_pvalue,
        "nobs": int(res.nobs),
        "cov_type": res.cov_type,
        "coef_pre": coef_pre,
        "coef_post": coef_post,
        "p_interaction": summary_df.loc["slope_diff", "pvalue"],
        "p_intercept_diff": summary_df.loc["intercept_diff", "pvalue"],
        "model": res,
        "data_long": long,
    }
