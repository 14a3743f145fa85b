"""R-formula parsing and design-matrix construction.

Reproduces the semantics the reference relies on:
- `parse_formula` (reference R/utilities.R:220-225): "~ covariates" only, a
  response on the LHS is an error; returns the covariate (variable) names.
- `create_design_matrix` (reference R/utilities.R:887-900): R
  `stats::model.matrix` over the distinct (sample, covariates) rows arranged
  by sample id — treatment contrasts, intercept first, factor levels sorted.

The full additive/interaction formula language is supported: `~ 1`, `~ a`,
`~ a + b`, `~ a:b`, `~ a * b` (= `a + b + a:b`), and n-way crossings
(`a * b * c`). Semantics follow `stats::terms` + `stats::model.matrix`:

- `*` expands to all non-empty subsets of its operands; `:` binds tighter
  than `*`; duplicate variables within a term collapse (`a:a` = `a`).
- Terms are deduplicated and ordered by interaction order (main effects
  first, then two-way, ...), stable by first appearance — `terms()` with the
  default `keep.order = FALSE`.
- Interaction labels list variables in their order of first appearance in
  the formula (R's `variables` attribute order).
- Factor coding inside a term uses the S heuristic (Statistical Models in S,
  p.38, as implemented by R's model.c `TermCode`): a factor `v` in term `t`
  is coded by treatment contrasts iff `t \\ {v}` is the empty term (the
  intercept, always present here) or matches an earlier term; otherwise by
  full dummy variables. Hence `~ a * b` codes the interaction
  contrast x contrast, while the non-hierarchical `~ f:x` (numeric x) yields
  one slope per level of `f`, and `~ a:b` yields all level combinations
  (R reproduces that over-parameterization; so do we).
- Interaction columns are ordered with the FIRST variable varying fastest,
  names joined with ":" (e.g. `LabelHigh:batchB`).

Intercept removal (`~ 0 + ...`, `- 1`), `^`, `I(...)` and parentheses are
rejected with clear errors: the reference pipeline always keeps the
intercept (its slope/deleterious logic indexes design column 2,
R/utilities.R:1531, 493-513).
"""

from __future__ import annotations

import re

import numpy as np
import pandas as pd

_VAR_RE = re.compile(r"[A-Za-z.][A-Za-z0-9._]*|`[^`]+`")


def _check_rhs(rhs: str) -> None:
    for op, why in (
        ("^", "power terms are not supported"),
        ("I(", "I(...) terms are not supported"),
        ("(", "parentheses are not supported"),
        ("-", "term removal is not supported (reference always keeps the intercept)"),
    ):
        if op in rhs:
            raise ValueError(f"unsupported formula syntax {op!r}: {why}")


def _split_rhs(formula: str) -> list[str]:
    if not isinstance(formula, str):
        raise TypeError("formula must be a string like '~ Label'")
    s = formula.strip()
    if "~" not in s:
        raise ValueError('The formula must be of the kind "~ covariates"')
    lhs, rhs = s.split("~", 1)
    if lhs.strip():
        raise ValueError('The formula must be of the kind "~ covariates"')
    rhs = rhs.strip()
    _check_rhs(rhs)
    return [c.strip() for c in rhs.split("+")] if rhs else []


def _parse_var(tok: str) -> str:
    tok = tok.strip()
    if not _VAR_RE.fullmatch(tok):
        raise ValueError(f"unsupported formula term {tok!r}")
    return tok.strip("`")


def _expand_chunk(chunk: str) -> list[tuple[str, ...]]:
    """Expand one `+`-separated chunk into raw terms (tuples of variables).

    `:` binds tighter than `*`; `a * b` crosses to `a + b + a:b`
    (all non-empty subsets of the `*` operands, each operand itself a
    `:`-joined variable tuple).
    """
    parts = [p.strip() for p in chunk.split("*")]
    operands: list[tuple[str, ...]] = []
    for p in parts:
        if not p:
            raise ValueError(f"malformed formula term {chunk!r}")
        operands.append(tuple(_parse_var(v) for v in p.split(":")))
    # all non-empty subsets, in R's expansion order: singles, pairs, ...
    out: list[tuple[str, ...]] = []
    n = len(operands)
    for size in range(1, n + 1):
        # subsets of a given size in lexicographic index order
        def rec(start: int, acc: tuple[str, ...], left: int) -> None:
            if left == 0:
                out.append(acc)
                return
            for i in range(start, n - left + 1):
                rec(i + 1, acc + operands[i], left - 1)

        rec(0, (), size)
    return out


def parse_terms(formula: str) -> tuple[list[str], list[tuple[str, ...]]]:
    """Parse a formula into (variables, terms) with R `terms()` semantics.

    Returns the variables in order of first appearance and the deduplicated
    term list, each term a tuple of variable names in appearance order,
    sorted stably by interaction order (main effects first).
    """
    raw_terms: list[tuple[str, ...]] = []
    for chunk in _split_rhs(formula):
        if chunk in ("", "1"):
            continue
        if chunk == "0":
            raise ValueError("intercept removal is not supported (reference always keeps it)")
        raw_terms.extend(_expand_chunk(chunk))

    variables: list[str] = []
    for t in raw_terms:
        for v in t:
            if v not in variables:
                variables.append(v)
    var_pos = {v: i for i, v in enumerate(variables)}

    seen: set[frozenset[str]] = set()
    canon: list[tuple[str, ...]] = []
    for t in raw_terms:
        # duplicate variables inside a term collapse (a:a == a)
        key = frozenset(t)
        if key in seen:
            continue
        seen.add(key)
        canon.append(tuple(sorted(set(t), key=var_pos.__getitem__)))
    canon.sort(key=len)  # stable: main effects, then 2-way, ...
    return variables, canon


def parse_formula(formula: str) -> list[str]:
    """Return the covariate (variable) names of a "~ covariates" formula.

    Mirrors reference R/utilities.R:220-225 (all.vars of the RHS): a
    left-hand side (response) is rejected; `~ 1` yields an empty list.
    """
    variables, _ = parse_terms(formula)
    return variables


def _is_numeric(col: pd.Series) -> bool:
    return pd.api.types.is_numeric_dtype(col) and not pd.api.types.is_bool_dtype(col)


def _factor_levels(col: pd.Series) -> tuple[list, np.ndarray]:
    if pd.api.types.is_bool_dtype(col):
        return [False, True], col.to_numpy()
    vals = col.astype(str).to_numpy()
    return sorted(set(vals)), vals


def _term_columns(
    data: pd.DataFrame,
    term: tuple[str, ...],
    earlier: list[frozenset[str]],
) -> tuple[list[np.ndarray], list[str]]:
    """Columns for one term under the S coding heuristic (see module doc)."""
    tset = frozenset(term)
    per_var: list[list[tuple[str, np.ndarray]]] = []
    for v in term:
        col = data[v]
        if _is_numeric(col):
            per_var.append([(v, col.to_numpy(dtype=np.float64))])
            continue
        levels, vals = _factor_levels(col)
        rest = tset - {v}
        contrasts = len(rest) == 0 or rest in earlier
        use_levels = levels[1:] if contrasts else levels
        per_var.append([(f"{v}{lev}", (vals == lev).astype(np.float64)) for lev in use_levels])
    # product with the FIRST variable varying fastest (R column order)
    cols: list[np.ndarray] = []
    names: list[str] = []
    idx = [0] * len(per_var)
    total = 1
    for pv in per_var:
        total *= len(pv)
    for _ in range(total):
        prod = per_var[0][idx[0]][1].copy()
        name = per_var[0][idx[0]][0]
        for j in range(1, len(per_var)):
            prod = prod * per_var[j][idx[j]][1]
            name = f"{name}:{per_var[j][idx[j]][0]}"
        cols.append(prod)
        names.append(name)
        for j in range(len(per_var)):  # increment mixed-radix, first fastest
            idx[j] += 1
            if idx[j] < len(per_var[j]):
                break
            idx[j] = 0
    return cols, names


def model_matrix(
    data: pd.DataFrame, covariates: list[str] | list[tuple[str, ...]]
) -> tuple[np.ndarray, list[str]]:
    """Build an R `model.matrix` equivalent over pre-parsed terms.

    `covariates` is either a list of variable names (main effects only, the
    historical call shape) or a list of term tuples from `parse_terms`.
    Treatment contrasts; factor levels sorted (R `factor()` default);
    intercept column first. Returns (X, column_names).
    """
    terms: list[tuple[str, ...]] = [(t,) if isinstance(t, str) else tuple(t) for t in covariates]
    n = len(data)
    cols: list[np.ndarray] = [np.ones(n)]
    names: list[str] = ["(Intercept)"]
    earlier: list[frozenset[str]] = []
    for t in terms:
        tcols, tnames = _term_columns(data, t, earlier)
        cols.extend(tcols)
        names.extend(tnames)
        earlier.append(frozenset(t))
    return np.column_stack(cols), names


def create_design_matrix(
    df: pd.DataFrame, formula: str, sample_col: str
) -> tuple[np.ndarray, list[str], pd.DataFrame]:
    """Design matrix over distinct samples arranged by sample id.

    Mirrors reference R/utilities.R:887-900. Returns (X, colnames,
    sample_rows) where sample_rows is the distinct-sample frame in design-row
    order.
    """
    variables, terms = parse_terms(formula)
    sub = df[[sample_col] + variables].drop_duplicates().sort_values(sample_col, kind="stable")
    if sub[sample_col].duplicated().any():
        dup = sub[sample_col][sub[sample_col].duplicated()].iloc[0]
        raise ValueError(
            f"sample {dup!r} maps to more than one covariate combination; "
            "covariates must be constant within a sample"
        )
    sub = sub.reset_index(drop=True)
    X, names = model_matrix(sub, terms)
    return X, names, sub
