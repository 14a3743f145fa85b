"""The port's gene selection and G/S indexing (ppcseq_tpu_torch/data/ingest.py)
against the JAX package's, frame for frame, on small synthetic tables that
stress the ranking: shuffled rows, significance tied across transcripts or
varying within one, check and control genes that tie, integer and NaN
significance, duplicated (transcript, sample) pairs and a table that is not
a full rectangle, at negative-control counts from 0 past the number of
transcripts; and a missing transcript key against a plain pandas reading
of the reference's selection."""

import numpy as np
import pandas as pd
import pytest

from ppcseq_tpu.data import ingest as jingest
from ppcseq_tpu_torch.data import ingest

N_T, N_S, N_CHECK = 300, 24, 12  # transcripts, samples, checked transcripts


def _table(rng, pvalue=None):
    """N_T transcripts x N_S samples, sample-major, one significance value
    per transcript unless `pvalue` gives one per row."""
    n = N_T * N_S
    if pvalue is None:
        pvalue = np.tile(rng.uniform(size=N_T), N_S)
    return pd.DataFrame({
        "sample": np.repeat([f"s{i:02d}" for i in range(N_S)], N_T),
        "transcript": np.tile([f"g{j:03d}" for j in range(N_T)], N_S),
        "value": rng.integers(0, 1000, n),
        "Label": np.repeat(np.where(np.arange(N_S) < N_S // 2, "Low", "High"), N_T),
        "PValue": pvalue,
        "do_check": np.tile(np.arange(N_T) < N_CHECK, N_S),
    })


def _shuffled(rng, df):
    return df.iloc[rng.permutation(len(df))].reset_index(drop=True)


def _ordered(rng):
    return _table(rng)


def _rows_shuffled(rng):
    return _shuffled(rng, _table(rng))


def _tied_across_transcripts(rng):
    df = _table(rng)
    return _shuffled(rng, df.assign(PValue=df.PValue.round(1)))


def _varying_within_transcripts(rng):
    return _shuffled(rng, _table(rng, pvalue=rng.uniform(size=N_T * N_S)))


def _check_and_control_tie(rng):
    """Checked transcripts share their values with unchecked ones, and a
    transcript is checked on some of its rows only."""
    pv = rng.uniform(size=N_T)
    pv[:N_CHECK] = pv[N_CHECK:2 * N_CHECK]
    df = _table(rng, pvalue=np.tile(pv, N_S))
    partly = (df.transcript == f"g{N_CHECK + 1:03d}") & (df["sample"] < "s05")
    return _shuffled(rng, df.assign(do_check=df.do_check | partly))


def _integer_significance(rng):
    return _shuffled(rng, _table(rng, pvalue=rng.integers(0, 6, N_T * N_S)))


def _nan_significance(rng):
    """Some rows of many transcripts NaN, and every row of a few."""
    df = _table(rng, pvalue=rng.uniform(size=N_T * N_S).round(2))
    pv = df.PValue.to_numpy().copy()
    pv[rng.uniform(size=len(pv)) < 0.3] = np.nan
    pv[df.transcript.isin(["g020", "g021", "g150", "g299"]).to_numpy()] = np.nan
    return _shuffled(rng, df.assign(PValue=pv))


def _duplicated_pairs(rng):
    df = _table(rng)
    dup = df.sample(n=500, random_state=int(rng.integers(1 << 31)))
    return _shuffled(rng, pd.concat([df, dup.assign(value=dup.value + 1)], ignore_index=True))


def _not_a_rectangle(rng):
    df = _table(rng)
    return _shuffled(rng, df[rng.uniform(size=len(df)) > 0.05])


TABLES = {f.__name__.lstrip("_"): f for f in (
    _ordered, _rows_shuffled, _tied_across_transcripts, _varying_within_transcripts,
    _check_and_control_tie, _integer_significance, _nan_significance, _duplicated_pairs,
    _not_a_rectangle)}


@pytest.mark.parametrize("controls", [0, 1, 50, N_T, N_T + 7])
@pytest.mark.parametrize("table", list(TABLES))
def test_selection_and_indices_equal_jax(table, controls):
    df = TABLES[table](np.random.default_rng(len(table) * 1000 + controls))
    sel = ("do_check", "PValue", "transcript", controls)
    got = ingest.select_to_check_and_house_keeping(df, *sel)
    assert got.equals(jingest.select_to_check_and_house_keeping(df, *sel))
    args = (df, "~ Label", "sample", "transcript", "value", "do_check", "PValue", controls)
    got = ingest.format_input(*args)
    want = jingest.format_input(*args)
    assert got.equals(want)
    assert list(got.dtypes) == list(want.dtypes)


@pytest.mark.parametrize("controls", [0, 1, 2, 3])
def test_a_missing_transcript_key_is_one_transcript(controls):
    """A row without a transcript key belongs to one transcript of its own,
    as the reference's distinct() treats NA: the controls equal a plain
    stable sort and distinct in pandas."""
    df = pd.DataFrame({
        "sample": ["a", "b"] * 4,
        "transcript": ["x", "x", None, None, "y", "y", "z", "z"],
        "PValue": [0.1, 0.1, 0.9, 0.9, 0.5, 0.5, 0.7, 0.7],
        "do_check": [True, True] + [False] * 6,
    })
    ranked = df.sort_values("PValue", kind="stable").drop_duplicates("transcript").transcript
    tail = ranked.iloc[len(ranked) - min(controls, len(ranked)):]
    want = pd.concat([df[df.do_check], df[~df.do_check & df.transcript.isin(tail)]],
                     ignore_index=True)
    got = ingest.select_to_check_and_house_keeping(df, "do_check", "PValue", "transcript",
                                                   controls)
    assert got.equals(want)
