"""Input validation, gene selection, and index assignment.

Reproduces the reference's data-preparation layer (SURVEY.md §1 L4):
- column / NA / integer-count validation (reference R/methods.R:110-153,
  R/utilities.R:804-852)
- `select_to_check_and_house_keeping` (reference R/utilities.R:628-649):
  genes flagged for checking plus the bottom-N least-significant transcripts
  as negative controls for the hyperprior/overdispersion-trend inference
- `format_input` (reference R/utilities.R:924-959): transcript -> G index
  (check genes first, so G in [0, n_check) are the tested ones) and
  sample -> S index by order of first appearance
- rectangularity check (reference R/utilities.R:1360-1361)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd

from ppcseq_tpu_torch import _native
from ppcseq_tpu_torch.formula.design import parse_formula


def check_columns_exist(df: pd.DataFrame, columns: list[str]) -> None:
    missing = [c for c in columns if c not in df.columns]
    if missing:
        raise ValueError(f"The columns {' '.join(missing)} are not present in your data frame")


def check_if_any_na(df: pd.DataFrame, columns: list[str]) -> None:
    sub = df[columns]
    if sub.isna().any().any():
        raise ValueError(
            f"There are NA values in your data frame for any of the columns {', '.join(columns)}"
        )


def check_integer_counts(df: pd.DataFrame, abundance: str) -> None:
    if not pd.api.types.is_integer_dtype(df[abundance]):
        raise TypeError(
            f"The column {abundance} must be of integer dtype. "
            f"You can do df[{abundance!r}] = df[{abundance!r}].astype(int)"
        )


def check_rectangular(df: pd.DataFrame, sample: str, transcript: str) -> None:
    """Every transcript must be present in all samples (reference R/utilities.R:1360).
    A missing (NaN) sample or transcript key is a ValueError naming its
    column: pd.factorize codes it -1, which the pair arithmetic below would
    take for another key."""
    codes_t, uniq_t = pd.factorize(df[transcript])
    codes_s, uniq_s = pd.factorize(df[sample])
    for role, column, codes in (("sample", sample, codes_s), ("transcript", transcript, codes_t)):
        n_missing = int(np.count_nonzero(codes < 0))
        if n_missing:
            raise ValueError(f"The {role} column {column!r} has {n_missing} missing keys (NaN); "
                             "every row needs a sample and a transcript")
    n_t, n_s = len(uniq_t), len(uniq_s)
    # distinct (sample, transcript) pairs, counted per transcript — all in C
    pair = codes_s.astype(np.int64) * n_t + codes_t
    if n_t * n_s <= max(4 * len(df), 1 << 22):
        # presence bitmap via bincount: ~100x cheaper than sorting the pairs
        present = np.bincount(pair, minlength=n_t * n_s) > 0
        per_t = present.reshape(n_s, n_t).sum(axis=0)
    else:
        upair = np.unique(pair)
        per_t = np.bincount(upair % n_t, minlength=n_t)
    if np.unique(per_t).size > 1:
        raise ValueError(
            "The input data frame does not represent a rectangular structure. "
            "Each transcript must be present in all samples."
        )


def select_to_check_and_house_keeping(
    df: pd.DataFrame,
    do_check: str,
    significance: str,
    transcript: str,
    how_many_negative_controls: int = 500,
) -> pd.DataFrame:
    """Check genes first, then negative-control rows.

    Mirrors reference R/utilities.R:628-649 exactly: the negative-control
    candidate list is the distinct transcripts of the WHOLE input arranged by
    ascending significance (stable), taking the last N (least significant);
    control rows are the non-check rows of those transcripts.
    """
    check_mask, control_mask, _, _ = _selection_masks(
        df, do_check, significance, transcript, how_many_negative_controls
    )
    return pd.concat(
        [df[check_mask], df[control_mask]], ignore_index=True
    )


def _selection_masks(df, do_check, significance, transcript,
                     how_many_negative_controls):
    """Boolean row masks (check rows, control rows) for the gene selection,
    with the rows' transcript codes (first-appearance order) and their count.

    "Stable-sort the rows by significance, distinct transcripts, take the
    last N" as a reduction over transcripts. A transcript's first row in the
    stable ascending order is the first of its rows holding its smallest
    value, NaN last as the sort puts it: a transcript ranks by its smallest
    non-NaN value, and one whose rows are all NaN after every other. So
    ordering the transcripts by (that value, that row) orders them by their
    first row in the sorted order, ties keeping the original row order, and
    only the transcripts' keys are sorted, never the rows (the row sort and
    a second over its codes cost ~1.4 s on a 5M-row cohort). An all-NaN
    transcript holds no row (`at` stays past the end), so the stable
    lexsort keeps those in code order, which is first-appearance order.
    """
    codes, uniq = pd.factorize(df[transcript], use_na_sentinel=False)
    n_codes = len(uniq)
    sig = df[significance].to_numpy()
    first = np.full(n_codes, len(codes))
    np.minimum.at(first, codes, np.arange(len(codes)))
    lowest = sig[first]  # each transcript's smallest value, NaN where all its rows are NaN
    np.fmin.at(lowest, codes, sig)
    holds = np.flatnonzero(sig == lowest[codes])
    at = np.full(n_codes, len(codes))  # the first row holding it
    np.minimum.at(at, codes[holds], holds)
    n_tail = min(how_many_negative_controls, n_codes)
    tail_codes = np.lexsort((at, lowest))[n_codes - n_tail:]
    is_tail = np.zeros(n_codes, dtype=bool)
    is_tail[tail_codes] = True

    check_mask = df[do_check].astype(bool).to_numpy()
    control_mask = ~check_mask & is_tail[codes]
    return check_mask, control_mask, codes, n_codes


def _first_appearance(codes: np.ndarray, n_codes: int) -> tuple[np.ndarray, int]:
    """`codes` (in [0, n_codes)) relabelled 0, 1, ... in order of first
    appearance, and the number of labels: a scatter-min of positions and a
    sort of the codes present, where np.unique would sort every row."""
    first = np.full(n_codes, len(codes))
    np.minimum.at(first, codes, np.arange(len(codes)))
    present = np.flatnonzero(first < len(codes))
    label = np.zeros(n_codes, dtype=np.int64)
    label[present[np.argsort(first[present])]] = np.arange(len(present))
    return label[codes], len(present)


def format_input(
    df: pd.DataFrame,
    formula: str,
    sample: str,
    transcript: str,
    abundance: str,
    do_check: str,
    significance: str,
    how_many_negative_controls: int = 500,
    span=None,
) -> pd.DataFrame:
    """Subset to check+control genes and assign G (transcript) / S (sample) indices.

    G and S are 0-based here (the reference's Stan indices are 1-based;
    everything downstream in this package is 0-based). Check genes come first
    in G order, exactly as in reference R/utilities.R:924-959. `span`, a
    `utils.log.timed` span, gets the counts `rows` (input rows), `kept` (rows
    returned) and `ranked` (transcript keys the selection sorted).
    """
    covariates = parse_formula(formula)
    check_mask, control_mask, codes, n_codes = _selection_masks(
        df, do_check, significance, transcript, how_many_negative_controls
    )
    keep_cols = [transcript, sample, abundance] + covariates + [do_check]
    # one positional take of the column subset — selecting masked copies of
    # the full frame and concatenating them cost ~6 s on a 5M-row cohort
    idx = np.concatenate([np.flatnonzero(check_mask), np.flatnonzero(control_mask)])
    sub = df[keep_cols].take(idx)

    # de-duplicate by (transcript, sample) first occurrence: for rectangular
    # inputs one row exists per pair, so this equals the reference's
    # distinct() across the kept columns (R/utilities.R:940) while running
    # at C speed instead of hashing object columns. First-appearance labels
    # double as the G/S indices, check genes first — exactly the reference's
    # scheme; G relabels the selection's transcript codes.
    codes_t, n_t = _first_appearance(codes[idx], n_codes)
    codes_s, uniq_s = pd.factorize(sub[sample])
    if len(sub) != n_t * len(uniq_s):  # full rectangle => no dups
        pair = codes_t * len(uniq_s) + codes_s
        _, first_idx = np.unique(pair, return_index=True)
        if len(first_idx) != len(sub):
            first_idx.sort()  # keep original row order of the kept rows
            sub = sub.iloc[first_idx]
            codes_t = codes_t[first_idx]
            codes_s = codes_s[first_idx]
    sub = sub.reset_index(drop=True)
    if span is not None:
        span.set(rows=len(df), kept=len(sub), ranked=n_codes)

    return sub.assign(G=codes_t, S=codes_s.astype(np.int64))


def _pivot_numpy(s_idx, g_idx, values, S: int, G: int) -> np.ndarray:
    """The NumPy scatter that `_native.pivot_counts` replaces: the plain
    version the tests hold the native pivot against."""
    counts = np.zeros((S, G), dtype=np.int64)
    counts[s_idx, g_idx] = values
    return counts


@dataclass
class ModelData:
    """Dense per-(sample, gene) arrays for the TPU model.

    The reference packs ragged CSR-like shards for Stan map_rect
    (R/utilities.R:125-174, 1389-1464); on TPU we use dense [S, G] arrays —
    rectangularity is enforced, so every gene has all S samples.
    """

    counts: np.ndarray  # [S, G] int64
    X: np.ndarray  # [S, C] float64, rows in S order
    exposure_rate: np.ndarray  # [S] float64
    n_check: int  # genes to check are G in [0, n_check)
    gene_names: list[str]  # length G, in G order
    sample_names: list[str]  # length S, in S order
    exclude_mask: np.ndarray  # [S, G] bool, True = excluded from likelihood


def build_model_data(
    my_df: pd.DataFrame,
    sample: str,
    transcript: str,
    abundance: str,
    do_check: str,
    X_by_sorted_sample: np.ndarray,
    sorted_sample_names: list[str],
    exposure_by_sample: dict[str, float],
    exclude: pd.DataFrame | None = None,
) -> ModelData:
    """Assemble dense model arrays from the indexed long frame.

    `X_by_sorted_sample` has rows ordered by sorted sample id (reference
    `create_design_matrix` arranges by sample, R/utilities.R:896); rows are
    re-indexed here to S (first appearance) order so every array is S-aligned.
    The reference indexes the design matrix positionally by S
    (stan:205 `X * alpha` with rows hit via sample_idx); for the bundled data
    both orders coincide, and re-aligning keeps arbitrary inputs correct.
    """
    check_rectangular(my_df, sample, transcript)

    gene_names = pd.factorize(my_df[transcript])[1].tolist()  # first-appearance order
    sample_names = pd.factorize(my_df[sample])[1].tolist()
    S, G = len(sample_names), len(gene_names)

    counts = _native.pivot_counts(
        my_df["S"].to_numpy(), my_df["G"].to_numpy(), my_df[abundance].to_numpy(), S, G
    )

    pos_in_sorted = {name: i for i, name in enumerate(sorted_sample_names)}
    X = np.asarray(X_by_sorted_sample, dtype=np.float64)[
        [pos_in_sorted[s] for s in sample_names], :
    ]
    exposure = np.array([exposure_by_sample[s] for s in sample_names], dtype=np.float64)

    n_check = int(my_df.loc[my_df[do_check].astype(bool), "G"].max()) + 1 if my_df[do_check].any() else 0

    exclude_mask = np.zeros((S, G), dtype=bool)
    if exclude is not None and len(exclude):
        exclude_mask[exclude["S"].to_numpy(), exclude["G"].to_numpy()] = True

    return ModelData(
        counts=counts,
        X=X,
        exposure_rate=exposure,
        n_check=n_check,
        gene_names=gene_names,
        sample_names=sample_names,
        exclude_mask=exclude_mask,
    )
