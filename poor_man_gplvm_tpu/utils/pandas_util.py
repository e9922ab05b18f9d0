"""Declarative DataFrame filtering: spec-tree -> (mask, pandas query string).

Equivalent of reference poor_man_gplvm/pandas_util.py: logic nodes
(``all``/``any``/``not`` as dicts or tagged lists), leaf conditions
``[col, op, value?, opts?]`` with comparator / membership / between / null /
string operators, and an implicit-AND list form.

Internally this is a two-stage compiler, unlike the reference's single
recursive walk: ``_parse`` first normalizes every accepted input form
(dict logic nodes, tagged lists, bare leaves, implicit-AND lists) into a
uniform ``(tag, children)`` tree, and ``_Compiler`` then evaluates that
tree against a concrete DataFrame, dispatching leaves through the
``_OP_HANDLERS`` table and interning query ``@``-parameters as it goes.
"""

from __future__ import annotations

import operator
import re
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import pandas as pd

Spec = Union[List[Any], Tuple[Any, ...], Dict[str, Any]]

__all__ = ["filter_df_with_spec"]

_BRANCH_TAGS = frozenset({"all", "any", "not"})


# ---------------------------------------------------------------------------
# stage 1: normalize the accepted spec forms into a uniform tagged tree
# ---------------------------------------------------------------------------
# Node shapes after parsing:
#   ("all"|"any", [child, ...])
#   ("not", [child])
#   ("leaf", (col, op, value, opts))


def _branch_tag_of(node):
    """The logic tag a list/dict node carries, or None for leaves."""
    if isinstance(node, dict):
        for tag in ("not", "all", "any"):
            if tag in node:
                return tag
        return None
    if (
        isinstance(node, (list, tuple))
        and node
        and isinstance(node[0], str)
        and node[0].lower() in _BRANCH_TAGS
    ):
        return node[0].lower()
    return None


def _parse(spec):
    tag = _branch_tag_of(spec)
    if tag is not None:
        if isinstance(spec, dict):
            body = spec[tag]
            kids = (
                list(body)
                if tag != "not" and isinstance(body, (list, tuple))
                else [body]
            )
        else:  # tagged list form: ['all'|'any'|'not', child, ...]
            kids = list(spec[1:])
            if tag == "not" and len(kids) != 1:
                raise ValueError("['not', spec] expects exactly one child.")
        return tag, [_parse(k) for k in kids]

    if isinstance(spec, (list, tuple)):
        if not spec:
            raise ValueError("Empty spec list.")
        if len(spec) >= 2 and isinstance(spec[0], str):
            # bare leaf: [col, op, value?, opts?]
            col, op = spec[0], str(spec[1]).lower()
            value = spec[2] if len(spec) > 2 else None
            opts = (
                spec[3]
                if len(spec) > 3 and isinstance(spec[3], dict)
                else {}
            )
            return "leaf", (col, op, value, opts)
        # implicit AND over a bare list of nodes
        return "all", [_parse(k) for k in spec]

    raise ValueError("Invalid spec structure.")


# ---------------------------------------------------------------------------
# stage 2: evaluate the tagged tree against a DataFrame
# ---------------------------------------------------------------------------

_CMP_OPS = {
    "==": operator.eq, "!=": operator.ne,
    "<": operator.lt, ">": operator.gt,
    "<=": operator.le, ">=": operator.ge,
}

#: (lower-bound op, upper-bound op) per pandas `inclusive` flavor, for the
#: query-string rendering of `between` (legacy bool values included)
_BETWEEN_BOUNDS = {
    "both": ("<=", "<="), "neither": ("<", "<"),
    "left": ("<=", "<"), "right": ("<", "<="),
    True: ("<=", "<="), False: ("<", "<"),
}


class _Compiler:
    """Walks a parsed spec tree, producing a boolean mask and an
    equivalent ``df.query`` string whose ``@``-parameters it interns
    into ``self.env``."""

    def __init__(self, df):
        self.df = df
        self.env: Dict[str, Any] = {}

    def intern(self, value):
        """Bind ``value`` to a fresh env name; return its ``@``-reference."""
        ref = f"v{len(self.env)}"
        self.env[ref] = value
        return f"@{ref}"

    def column(self, name):
        if name not in self.df.columns:
            raise KeyError(f"Column '{name}' not in DataFrame.")
        # backtick-quote anything that isn't a plain identifier
        quoted = name if re.fullmatch(r"\w+", name) else f"`{name}`"
        return self.df[name], quoted

    def run(self, node):
        tag, body = node
        if tag == "leaf":
            col, op, value, opts = body
            series, colref = self.column(col)
            handler = _OP_HANDLERS.get(op)
            if handler is None:
                raise ValueError(f"Unsupported op: {op}")
            return handler(self, series, colref, op, value, opts)
        if tag == "not":
            mask, q = self.run(body[0])
            return ~mask, f"not ({q})"
        # all / any
        parts = [self.run(kid) for kid in body]
        masks = [m for m, _ in parts]
        if tag == "all":
            combined = np.logical_and.reduce(masks) if parts else np.ones(
                len(self.df), dtype=bool
            )
            glue = " and "
        else:
            combined = np.logical_or.reduce(masks) if parts else np.zeros(
                len(self.df), dtype=bool
            )
            glue = " or "
        mask = pd.Series(np.asarray(combined), index=self.df.index)
        q = glue.join(f"({snippet})" for _, snippet in parts)
        return mask, (f"({q})" if q else "")


# --- leaf op handlers (each returns (mask, query-snippet)) -----------------


def _op_compare(c, series, colref, op, value, opts):
    return _CMP_OPS[op](series, value), f"{colref} {op} {c.intern(value)}"


def _op_membership(c, series, colref, op, value, opts):
    if not isinstance(value, (list, tuple, set, pd.Index, np.ndarray)):
        value = [value]
    ref = c.intern(list(value))
    mask = series.isin(c.env[ref[1:]])
    if op == "not in":
        return ~mask, f"{colref} not in {ref}"
    return mask, f"{colref} in {ref}"


def _op_between(c, series, colref, op, value, opts):
    if not (isinstance(value, (list, tuple)) and len(value) == 2):
        raise ValueError("between expects value=(low, high).")
    lo, hi = value
    inclusive = opts.get("inclusive", "both")
    lo_op, hi_op = _BETWEEN_BOUNDS.get(inclusive, ("<=", "<="))
    q = (
        f"({c.intern(lo)} {lo_op} {colref})"
        f" and ({colref} {hi_op} {c.intern(hi)})"
    )
    return series.between(lo, hi, inclusive=inclusive), q


def _op_null(c, series, colref, op, value, opts):
    if op in ("isna", "isnull"):
        return series.isna(), f"{colref}.isnull()"
    return series.notna(), f"{colref}.notnull()"


def _op_string(c, series, colref, op, value, opts):
    pattern = str(value)
    na = opts.get("na", False)
    text = series.astype("string")
    ref = c.intern(pattern)
    if op in ("contains", "regex"):
        case = bool(opts.get("case", True))
        use_regex = True if op == "regex" else bool(opts.get("regex", True))
        mask = text.str.contains(pattern, case=case, na=na, regex=use_regex)
        q = (
            f"{colref}.str.contains({ref}, case={case}, na={na},"
            f" regex={use_regex})"
        )
        return mask, q
    mask = getattr(text.str, op)(pattern, na=na)
    return mask, f"{colref}.str.{op}({ref}, na={na})"


_OP_HANDLERS = {}
for _op in _CMP_OPS:
    _OP_HANDLERS[_op] = _op_compare
for _op in ("in", "not in"):
    _OP_HANDLERS[_op] = _op_membership
_OP_HANDLERS["between"] = _op_between
for _op in ("isna", "isnull", "notna", "notnull"):
    _OP_HANDLERS[_op] = _op_null
for _op in ("contains", "regex", "startswith", "endswith"):
    _OP_HANDLERS[_op] = _op_string
del _op


def filter_df_with_spec(df, spec, *, return_query=True):
    """Filter a DataFrame with a spec tree.

    Returns {'df': filtered, 'mask': boolean Series} plus, when
    ``return_query``, the equivalent pandas query string and its @-variable
    environment."""
    compiler = _Compiler(df)
    mask, query = compiler.run(_parse(spec))
    out = {"df": df[mask], "mask": mask}
    if return_query:
        out["query"] = query
        out["env"] = compiler.env
    return out
