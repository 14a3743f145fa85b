"""Minimal reader for R serialization format version 2 ("RDX2", XDR binary).

A copy of ppcseq_tpu/data/rdata.py for the port: the reader that extracted
the bundled dataset (the reference's `data/counts.rda`, R/data.R:1-5) into
fixtures/counts.parquet without an R runtime. Implemented from the publicly
documented R internals serialization layout.

Supports the subset of SEXP types needed for data.frames/tibbles saved with
`save()`: NULL, symbols, pairlists, character/integer/real/logical vectors,
generic vectors (lists), attributes, the reference table, and the ALTREP
representations R >= 3.5 emits for compact integer sequences and wrapped
vectors (used for `row.names`). gzip, bzip2 and xz files, or none.
"""

from __future__ import annotations

import bz2
import gzip
import struct

import numpy as np
import pandas as pd

# SEXP type codes (R internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
EXPRSXP = 20
RAWSXP = 24

# Special serialization codes
REFSXP = 255
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 252
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 250
NAMESPACESXP = 249
PACKAGESXP = 248
ALTREP_SXP = 238
ATTRLANGSXP = 240
ATTRLISTSXP = 239

R_NA_INT = -2147483648


class RObject:
    """A parsed R object: value plus attribute dict."""

    def __init__(self, value, attributes: dict[str, RObject] | None = None):
        self.value = value
        self.attributes = {} if attributes is None else attributes

    def __repr__(self) -> str:
        return f"RObject(value={self.value!r}, attributes={self.attributes!r})"

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return a.value if a is not None else default


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: list = []

    def _read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError("unexpected end of RData stream")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self._read(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._read(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self._read(8))[0]

    def i32_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(4 * n), dtype=">i4").astype(np.int64)

    def f64_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(8 * n), dtype=">f8").astype(np.float64)

    # --- object reading ------------------------------------------------
    def read_object(self):
        flags = self.u32()
        sexptype = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if sexptype == NILVALUE_SXP or sexptype == NILSXP:
            return None
        if sexptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if sexptype == SYMSXP:
            name_obj = self.read_object()  # CHARSXP
            sym = name_obj.value if isinstance(name_obj, RObject) else name_obj
            self.refs.append(sym)
            return sym
        if sexptype in (GLOBALENV_SXP, BASENAMESPACE_SXP, UNBOUNDVALUE_SXP, MISSINGARG_SXP):
            return None
        if sexptype in (PACKAGESXP, NAMESPACESXP):
            # persistent name: a STRSXP-like char vec preceded by an int
            self.u32()
            n = self.u32()
            names = [self.read_object() for _ in range(n)]
            self.refs.append(names)
            return names
        if sexptype == LISTSXP:
            # pairlist node
            attrs = self._read_attr_dict() if has_attr else {}
            tag = self.read_object() if has_tag else None
            car = self.read_object()
            cdr = self.read_object()
            pairs = [(tag, car)]
            if isinstance(cdr, list):
                pairs.extend(cdr)
            elif cdr is not None:
                pairs.append((None, cdr))
            if attrs:
                # rare: attributes on a pairlist node; ignore beyond value
                pass
            return pairs
        if sexptype == CHARSXP:
            n = self.i32()
            if n == -1:
                return RObject(None)
            return RObject(self._read(n).decode("utf-8", errors="replace"))
        if sexptype == LGLSXP:
            n = self.u32()
            raw = self.i32_array(n)
            vals = np.where(raw == R_NA_INT, np.nan, raw.astype(float))
            obj = RObject(vals if np.isnan(vals).any() else raw.astype(bool))
            self._finish_attrs(obj, has_attr)
            return obj
        if sexptype == INTSXP:
            n = self.u32()
            obj = RObject(self.i32_array(n))
            self._finish_attrs(obj, has_attr)
            return obj
        if sexptype == REALSXP:
            n = self.u32()
            obj = RObject(self.f64_array(n))
            self._finish_attrs(obj, has_attr)
            return obj
        if sexptype == CPLXSXP:
            n = self.u32()
            arr = np.frombuffer(self._read(16 * n), dtype=">c16").astype(np.complex128)
            obj = RObject(arr)
            self._finish_attrs(obj, has_attr)
            return obj
        if sexptype == RAWSXP:
            n = self.u32()
            obj = RObject(np.frombuffer(self._read(n), dtype=np.uint8))
            self._finish_attrs(obj, has_attr)
            return obj
        if sexptype == STRSXP:
            n = self.u32()
            vals = []
            for _ in range(n):
                c = self.read_object()
                vals.append(c.value if isinstance(c, RObject) else c)
            obj = RObject(np.array(vals, dtype=object))
            self._finish_attrs(obj, has_attr)
            return obj
        if sexptype in (VECSXP, EXPRSXP):
            n = self.u32()
            vals = [self.read_object() for _ in range(n)]
            obj = RObject(vals)
            self._finish_attrs(obj, has_attr)
            return obj
        if sexptype == ALTREP_SXP:
            info = self.read_object()  # pairlist: (class_sym, package, type)
            state = self.read_object()
            attr = self.read_object()
            obj = self._decode_altrep(info, state)
            if attr:
                if isinstance(attr, list):
                    for tag, val in attr:
                        if tag is not None:
                            obj.attributes[tag] = val if isinstance(val, RObject) else RObject(val)
            return obj
        raise NotImplementedError(f"SEXP type {sexptype} not supported")

    def _decode_altrep(self, info, state) -> RObject:
        class_name = None
        if isinstance(info, list) and info:
            first = info[0][1] if info[0][0] is None else info[0][0]
            if isinstance(first, str):
                class_name = first
            elif isinstance(first, list) and first:
                class_name = first[0]
        # info may itself be the pairlist [(None, [class, pkg, type])...]
        if class_name is None and isinstance(info, list):
            for _tag, val in info:
                if isinstance(val, str):
                    class_name = val
                    break
        if class_name == "compact_intseq":
            n, start, step = (state.value if isinstance(state, RObject) else state)
            return RObject(np.arange(start, start + n * step, step, dtype=np.int64)[: int(n)])
        if class_name == "compact_realseq":
            n, start, step = (state.value if isinstance(state, RObject) else state)
            return RObject(np.arange(start, start + n * step, step, dtype=np.float64)[: int(n)])
        if class_name in ("wrap_real", "wrap_integer", "wrap_logical", "wrap_string", "wrap_complex", "wrap_raw"):
            # state is a pairlist-like (wrapped, metadata) or a VECSXP
            if isinstance(state, RObject) and isinstance(state.value, list):
                inner = state.value[0]
                return inner if isinstance(inner, RObject) else RObject(inner)
            if isinstance(state, list) and state:
                inner = state[0][1]
                return inner if isinstance(inner, RObject) else RObject(inner)
        if class_name == "deferred_string":
            # state: (values, format); realize by formatting numbers like R would
            src = state
            if isinstance(src, RObject) and isinstance(src.value, list):
                src = src.value[0]
            arr = src.value if isinstance(src, RObject) else src
            return RObject(np.array([_format_r(v) for v in arr], dtype=object))
        raise NotImplementedError(f"ALTREP class {class_name!r} not supported")

    def _read_attr_dict(self) -> dict:
        attrs_pl = self.read_object()
        out = {}
        if isinstance(attrs_pl, list):
            for tag, val in attrs_pl:
                if tag is not None:
                    out[tag] = val if isinstance(val, RObject) else RObject(val)
        return out

    def _finish_attrs(self, obj: RObject, has_attr: bool):
        if has_attr:
            obj.attributes = self._read_attr_dict()


def _format_r(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    f = float(v)
    if f.is_integer():
        return str(int(f))
    return repr(f)


def _decompress(raw: bytes) -> bytes:
    if raw[:3] == b"BZh":
        return bz2.decompress(raw)
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        import lzma

        return lzma.decompress(raw)
    return raw


def read_rda(path: str) -> dict[str, RObject]:
    """Read a .rda / .RData file, returning {name: RObject}."""
    with open(path, "rb") as f:
        data = _decompress(f.read())
    if not data.startswith(b"RDX2\n"):
        raise ValueError("not an RDX2 RData file")
    data = data[5:]
    if not data.startswith(b"X\n"):
        raise ValueError("only XDR (binary) RData supported")
    r = _Reader(data[2:])
    r.u32()  # serialization version
    r.u32()  # writer R version
    r.u32()  # min reader R version
    top = r.read_object()
    out: dict[str, RObject] = {}
    if isinstance(top, list):
        for tag, val in top:
            if tag is not None:
                out[tag] = val if isinstance(val, RObject) else RObject(val)
    return out


def r_dataframe_to_pandas(obj: RObject) -> pd.DataFrame:
    """Convert a parsed R data.frame / tibble RObject to a pandas DataFrame."""
    names = obj.attr("names")
    cols = {}
    for name, col in zip(names, obj.value):
        if not isinstance(col, RObject):
            cols[name] = col
            continue
        levels = col.attr("levels")
        if levels is not None:
            codes = np.asarray(col.value, dtype=np.int64)
            vals = np.array(
                [levels[c - 1] if c != R_NA_INT and c >= 1 else None for c in codes],
                dtype=object,
            )
            cols[name] = vals
        else:
            cols[name] = col.value
    return pd.DataFrame(cols)
