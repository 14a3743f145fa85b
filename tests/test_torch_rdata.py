"""The port's RData reader (ppcseq_tpu_torch/data/rdata.py) against the JAX
package's, on RDX2 streams built here byte by byte (XDR, big-endian, as R's
`save()` writes them): a data.frame with integer, real, logical, character
and factor columns, NA in each, `names`, `class` and both forms of
`row.names` (compact `c(NA, -n)` and an ALTREP `compact_intseq`), symbols
reused through the reference table, in gzip, bzip2 and uncompressed files.
No .rda file is kept in the repository."""

import bz2
import gzip
import struct

import numpy as np
import pandas as pd
import pytest

from ppcseq_tpu.data import rdata as jrdata
from ppcseq_tpu_torch.data import rdata

NA_INT = -(2**31)
NA_REAL = struct.unpack(">d", bytes.fromhex("7ff00000000007a2"))[0]  # R's NA_real_
NA_STRING = None

NILVALUE, SYM, LIST, CHAR, LGL, INT, REAL, STR, VEC, REF, ALTREP = (
    254, 1, 2, 9, 10, 13, 14, 16, 19, 255, 238)
IS_OBJECT, HAS_ATTR, HAS_TAG = 0x100, 0x200, 0x400
UTF8 = 1 << 15  # a CHARSXP's encoding bit, in the flags' levels field


class _Writer:
    """Serializes R objects as R's serialize.c does, for the subset a
    data.frame needs; symbols go into a reference table and are written as
    REFSXP the second time."""

    def __init__(self):
        self.out = bytearray()
        self.symbols: dict[str, int] = {}

    def u32(self, x):
        self.out += struct.pack(">I", x & 0xFFFFFFFF)

    def i32(self, x):
        self.out += struct.pack(">i", x)

    def sym(self, name):
        if name in self.symbols:
            self.u32((self.symbols[name] << 8) | REF)
            return
        self.u32(SYM)
        self.char(name)
        self.symbols[name] = len(self.symbols) + 1

    def char(self, s):
        if s is NA_STRING:
            self.u32(CHAR)
            self.i32(-1)
            return
        b = s.encode()
        self.u32(CHAR | (UTF8 << 12 if not b.isascii() else 0))
        self.i32(len(b))
        self.out += b

    def _head(self, t, attrs, obj=False):
        self.u32(t | (HAS_ATTR if attrs else 0) | (IS_OBJECT if obj else 0))

    def vector(self, t, values, attrs=None, obj=False):
        """INTSXP, REALSXP, LGLSXP or STRSXP with optional attributes
        (written after the data, as R does)."""
        self._head(t, attrs, obj)
        self.u32(len(values))
        for v in values:
            if t == STR:
                self.char(v)
            elif t == REAL:
                self.out += struct.pack(">d", v)
            else:
                self.i32(v)
        if attrs:
            self.pairlist(attrs)

    def pairlist(self, items):
        """A tagged pairlist: [(tag, writer of the value)]."""
        for tag, write in items:
            self.u32(LIST | (HAS_TAG if tag is not None else 0))
            if tag is not None:
                self.sym(tag)
            write()
        self.u32(NILVALUE)

    def compact_intseq(self, n, start):
        """ALTREP compact_intseq: info (class, package, type), then the state
        c(n, start, step) as doubles, then no attributes."""
        self.u32(ALTREP)
        self.u32(LIST)
        self.sym("compact_intseq")
        self.u32(LIST)
        self.sym("base")
        self.u32(LIST)
        self.vector(INT, [INT])
        self.u32(NILVALUE)
        self.vector(REAL, [float(n), float(start), 1.0])
        self.u32(NILVALUE)


# the frame every stream holds: (column, R type, R values, expected values)
N = 5
COLUMNS = [
    ("count", INT, [3, NA_INT, 0, 7, 2**31 - 1],
     np.array([3, NA_INT, 0, 7, 2**31 - 1], dtype=np.int64)),
    ("logFC", REAL, [0.5, NA_REAL, -1.25, 1e-300, 3.0],
     np.array([0.5, np.nan, -1.25, 1e-300, 3.0])),
    ("significant", LGL, [1, 0, 0, 1, 1], np.array([True, False, False, True, True])),
    ("checked", LGL, [1, NA_INT, 0, 1, 0], np.array([1.0, np.nan, 0.0, 1.0, 0.0])),
    ("symbol", STR, ["CYP1A1", NA_STRING, "LYZ", "ÅRT3", ""],
     np.array(["CYP1A1", None, "LYZ", "ÅRT3", ""], dtype=object)),
    ("Label", "factor", [2, 1, NA_INT, 2, 1],
     np.array(["Neoadjuvant", "High", None, "Neoadjuvant", "High"], dtype=object)),
]


def _rdx2(row_names):
    w = _Writer()
    w.out += b"RDX2\nX\n"
    w.u32(2)
    w.u32(0x040301)  # written by R 4.3.1
    w.u32(0x020300)
    w.u32(LIST | HAS_TAG)  # the top pairlist: counts = <data.frame>
    w.sym("counts")
    w._head(VEC, True, obj=True)
    w.u32(len(COLUMNS))
    for _, t, values, _ in COLUMNS:
        if t == "factor":
            w.vector(INT, values, obj=True, attrs=[
                ("levels", lambda: w.vector(STR, ["High", "Neoadjuvant"])),
                ("class", lambda: w.vector(STR, ["factor"]))])
        else:
            w.vector(t, values)
    names = [c[0] for c in COLUMNS]
    w.pairlist([
        ("names", lambda: w.vector(STR, names)),
        ("class", lambda: w.vector(STR, ["data.frame"])),  # "class" again: a REFSXP
        ("row.names", (lambda: w.vector(INT, [NA_INT, -N])) if row_names == "compact"
         else (lambda: w.compact_intseq(N, 1))),
    ])
    w.u32(NILVALUE)
    return bytes(w.out)


COMPRESS = {"gzip": gzip.compress, "bz2": bz2.compress, "none": lambda b: b}


@pytest.mark.parametrize("row_names", ["compact", "altrep"])
@pytest.mark.parametrize("compression", list(COMPRESS))
def test_read_rda_matches_jax_and_the_frame_written(row_names, compression, tmp_path):
    raw = _rdx2(row_names)
    assert raw.count(b"class") == 1  # the second "class" went as a reference
    path = tmp_path / "counts.rda"
    path.write_bytes(COMPRESS[compression](raw))

    objs, jobjs = rdata.read_rda(str(path)), jrdata.read_rda(str(path))
    assert list(objs) == list(jobjs) == ["counts"]
    obj, jobj = objs["counts"], jobjs["counts"]
    assert list(obj.attr("class")) == list(jobj.attr("class")) == ["data.frame"]
    assert list(obj.attr("names")) == [c[0] for c in COLUMNS]
    want_rows = [NA_INT, -N] if row_names == "compact" else list(range(1, N + 1))
    np.testing.assert_array_equal(obj.attr("row.names"), want_rows)
    np.testing.assert_array_equal(obj.attr("row.names"), jobj.attr("row.names"))
    factor = obj.value[-1]
    assert list(factor.attr("levels")) == ["High", "Neoadjuvant"]
    assert list(factor.attr("class")) == ["factor"]

    frame = rdata.r_dataframe_to_pandas(obj)
    pd.testing.assert_frame_equal(frame, jrdata.r_dataframe_to_pandas(jobj))
    want = pd.DataFrame({name: expected for name, _, _, expected in COLUMNS})
    pd.testing.assert_frame_equal(frame, want)


def test_read_rda_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "bad.rda"
    path.write_bytes(gzip.compress(b"RDA3\nX\n"))
    with pytest.raises(ValueError, match="RDX2"):
        rdata.read_rda(str(path))
    path.write_bytes(b"RDX2\nA\n")
    with pytest.raises(ValueError, match="XDR"):
        rdata.read_rda(str(path))
    path.write_bytes(_rdx2("compact")[:-40])
    with pytest.raises(EOFError):
        rdata.read_rda(str(path))
