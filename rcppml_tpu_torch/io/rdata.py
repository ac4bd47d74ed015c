"""Minimal R serialization (.rda / .rds, RData version 2/3) reader.

Implements just enough of R's XDR serialization grammar to load the
reference package's datasets (its ``data/*.rda``): numeric /
integer / logical / character vectors, matrices (dim/dimnames attributes),
lists, data.frame-ish structures, S4 ``dgCMatrix`` (-> scipy.sparse.csc),
and the ALTREP wrappers R >= 3.5 emits for compact sequences.

This is an independent implementation from the published R internals
documentation ("R Internals" §Serialization Formats); it shares no code
with the reference (which reads .rda via R itself).

The port's own copy of ``rcppml_tpu/io/rdata.py`` (pure numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import gzip
import struct
from typing import Any, Dict, Optional

import numpy as np

# SEXP type codes (R internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CLOSXP = 3
ENVSXP = 4
PROMSXP = 5
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
EXPRSXP = 20
RAWSXP = 24
S4SXP = 25
BASEENV_SXP = 241
EMPTYENV_SXP = 242
GENERICREFSXP = 245
CLASSREFSXP = 246
PERSISTSXP = 247
PACKAGESXP = 248
NAMESPACESXP = 249
BASENAMESPACE_SXP = 250
MISSINGARG_SXP = 251
UNBOUNDVALUE_SXP = 252
GLOBALENV_SXP = 253
NILVALUE_SXP = 254
REFSXP = 255
ALTREP_SXP = 238
ATTRLISTSXP = 239  # not a real code; placeholder


class RObject:
    """Parsed R object: .value holds the python payload, .attrs the
    attribute dict, .s4class the S4 class name when applicable."""

    __slots__ = ("value", "attrs", "s4class")

    def __init__(self, value, attrs=None, s4class=None):
        self.value = value
        self.attrs = attrs or {}
        self.s4class = s4class

    def __repr__(self):
        return f"RObject({type(self.value).__name__}, attrs={list(self.attrs)}, s4={self.s4class})"


class _Reader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0
        self.refs = []

    # -- low-level XDR reads ------------------------------------------------
    def _take(self, n):
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self):
        return self._take(1)[0]

    def i32(self):
        return struct.unpack(">i", self._take(4))[0]

    def f64(self):
        return struct.unpack(">d", self._take(8))[0]

    def ints(self, n):
        out = np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int32)
        return out

    def doubles(self, n):
        return np.frombuffer(self._take(8 * n), dtype=">f8").astype(np.float64)

    def length(self):
        n = self.i32()
        if n == -1:           # long vector: two 32-bit halves
            hi = self.i32()
            lo = self.i32()
            return (hi << 32) | lo
        return n

    # -- item parsing -------------------------------------------------------
    def read_item(self) -> Any:
        flags = self.i32()
        typ = flags & 255
        levels = flags >> 12
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)
        is_obj = bool(flags & 0x100)

        if typ == NILVALUE_SXP or typ == NILSXP:
            return None
        if typ == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i32()
            return self.refs[idx - 1]
        if typ == SYMSXP:
            name = self.read_item()          # CHARSXP
            sym = ("symbol", name)
            self.refs.append(sym)
            return sym
        if typ == CHARSXP:
            n = self.i32()
            if n == -1:
                return None                  # NA_character_
            return self._take(n).decode("utf-8", errors="replace")
        if typ in (LISTSXP, LANGSXP):
            # pairlist: attr? tag? car cdr
            attrs = self.read_item() if has_attr else None
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            return ("pairlist", tag, car, cdr, attrs)
        if typ in (GLOBALENV_SXP, BASEENV_SXP, EMPTYENV_SXP,
                   MISSINGARG_SXP, UNBOUNDVALUE_SXP):
            return ("env", typ)
        if typ == ENVSXP:
            self.i32()                       # locked flag
            env = ["env"]
            self.refs.append(env)
            enclos = self.read_item()
            frame = self.read_item()
            hashtab = self.read_item()
            attrs = self.read_item()
            env.extend([enclos, frame, hashtab, attrs])
            return env
        if typ == NAMESPACESXP or typ == PACKAGESXP or typ == PERSISTSXP:
            strvec = self._read_vec_strings()
            ref = ("namespace", strvec)
            self.refs.append(ref)
            return ref
        if typ == ALTREP_SXP:
            info = self.read_item()          # pairlist (class, pkg, type)
            state = self.read_item()
            attr = self.read_item()
            return self._decode_altrep(info, state, attr)
        if typ == LGLSXP:
            n = self.length()
            vals = self.ints(n)
            out = np.where(vals == -2147483648, -1, vals).astype(np.int8)
            return self._finish_vec(out.astype(bool), has_attr, is_obj)
        if typ == INTSXP:
            n = self.length()
            return self._finish_vec(self.ints(n), has_attr, is_obj)
        if typ == REALSXP:
            n = self.length()
            return self._finish_vec(self.doubles(n), has_attr, is_obj)
        if typ == CPLXSXP:
            n = self.length()
            re = self.doubles(2 * n)
            return self._finish_vec(re[0::2] + 1j * re[1::2], has_attr, is_obj)
        if typ == STRSXP:
            n = self.length()
            vals = [self.read_item() for _ in range(n)]
            return self._finish_vec(np.asarray(vals, dtype=object), has_attr,
                                    is_obj)
        if typ in (VECSXP, EXPRSXP):
            n = self.length()
            vals = [self.read_item() for _ in range(n)]
            return self._finish_vec(vals, has_attr, is_obj)
        if typ == RAWSXP:
            n = self.length()
            return self._finish_vec(np.frombuffer(self._take(n),
                                                  dtype=np.uint8),
                                    has_attr, is_obj)
        if typ == S4SXP:
            attrs = self.read_item() if has_attr else None
            ad = _pairlist_to_dict(attrs)
            cls = ad.get("class")
            clsname = None
            if cls is not None:
                cv = cls.value if isinstance(cls, RObject) else cls
                if isinstance(cv, np.ndarray) and cv.size:
                    clsname = str(cv[0])
            return RObject(None, ad, s4class=clsname)
        if typ == CLOSXP or typ == PROMSXP:
            # skip closures: attr? env, formals/args, body
            if has_attr:
                self.read_item()
            self.read_item()
            self.read_item()
            self.read_item()
            return None
        raise NotImplementedError(f"SEXP type {typ} not supported")

    def _read_vec_strings(self):
        self.i32()
        n = self.i32()
        return [self.read_item() for _ in range(n)]

    def _finish_vec(self, arr, has_attr, is_obj):
        if has_attr:
            attrs = _pairlist_to_dict(self.read_item())
            return RObject(arr, attrs)
        return arr

    def _decode_altrep(self, info, state, attr):
        """Decode the ALTREP classes R commonly serializes."""
        # info is a pairlist whose car is the class symbol
        cls = None
        if isinstance(info, tuple) and info[0] == "pairlist":
            car = info[2]
            if isinstance(car, tuple) and car[0] == "symbol":
                cls = car[1]
        if cls == "compact_intseq":
            st = state.value if isinstance(state, RObject) else state
            n, start, step = (int(st[0]), int(st[1]), int(st[2]))
            return np.arange(start, start + n * step, step, dtype=np.int32)
        if cls in ("wrap_real", "wrap_integer", "wrap_logical",
                   "wrap_string", "wrap_complex", "wrap_raw"):
            payload = state
            if isinstance(payload, tuple) and payload[0] == "pairlist":
                payload = payload[2]
            if attr is not None:
                return RObject(_unwrap(payload), _pairlist_to_dict(attr))
            return payload
        if cls == "deferred_string":
            payload = state
            if isinstance(payload, tuple) and payload[0] == "pairlist":
                payload = payload[2]
            arr = _unwrap(payload)
            return np.asarray([str(x) for x in np.ravel(arr)], dtype=object)
        raise NotImplementedError(f"ALTREP class {cls!r} not supported")


def _unwrap(x):
    return x.value if isinstance(x, RObject) else x


def _pairlist_to_dict(pl) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    node = pl
    while isinstance(node, tuple) and node and node[0] == "pairlist":
        _, tag, car, cdr, _attrs = node
        if isinstance(tag, tuple) and tag[0] == "symbol":
            out[tag[1]] = car
        node = cdr
    return out


class RMatrix(np.ndarray):
    """Dense R matrix with its attribute list preserved as ``.attrs``
    (e.g. attr(aml, "metadata_h"), R/data.R:71-100).  Behaves as a plain
    ndarray everywhere else."""

    attrs: Dict[str, Any] = {}

    def __array_finalize__(self, obj):
        if obj is not None:
            self.attrs = getattr(obj, "attrs", {})


def _to_python(obj):
    """Convert parsed objects to numpy / scipy / dict structures."""
    if isinstance(obj, RObject):
        attrs = obj.attrs
        if obj.s4class in ("dgCMatrix", "dsCMatrix", "dtCMatrix"):
            import scipy.sparse as sp
            i = _unwrap(attrs["i"]).astype(np.int32)
            p = _unwrap(attrs["p"]).astype(np.int32)
            x = _unwrap(attrs["x"]).astype(np.float64)
            dim = _unwrap(attrs["Dim"]).astype(int)
            mat = sp.csc_matrix((x, i, p), shape=tuple(dim))
            if obj.s4class == "dsCMatrix":
                mat = mat + sp.triu(mat, 1).T
            # carry non-slot R attributes (e.g. the datasets'
            # attr(x, "metadata_h") data frames, R/data.R:71-128) and
            # dimnames onto the scipy object as ``mat.attrs``
            slots = {"i", "p", "x", "Dim", "Dimnames", "factors", "uplo",
                     "class"}
            extra = {k: _to_python(v) for k, v in attrs.items()
                     if k not in slots}
            dn = attrs.get("Dimnames")
            if dn is not None:
                dn_py = _to_python(dn)
                if isinstance(dn_py, list) and len(dn_py) == 2:
                    extra["dimnames"] = dn_py
            if extra:
                mat.attrs = extra
            return mat
        if obj.s4class is not None:
            return {k: _to_python(v) for k, v in attrs.items()}
        val = obj.value
        dim = attrs.get("dim")
        if dim is not None and isinstance(val, np.ndarray):
            shape = tuple(int(x) for x in _unwrap(dim))
            arr = np.asarray(val).reshape(shape, order="F")
            extra = {k: _to_python(v) for k, v in attrs.items()
                     if k not in ("dim", "dimnames")}
            dn = attrs.get("dimnames")
            if dn is not None:
                dn_py = _to_python(dn)
                if isinstance(dn_py, list) and len(dn_py) == len(shape):
                    extra["dimnames"] = dn_py
            if extra:
                arr = arr.view(RMatrix)
                arr.attrs = extra
            return arr
        names = attrs.get("names")
        if names is not None and isinstance(val, list):
            nm = [str(x) for x in np.ravel(_unwrap(names))]
            return dict(zip(nm, (_to_python(v) for v in val)))
        if isinstance(val, list):
            return [_to_python(v) for v in val]
        return val
    if isinstance(val := obj, list):
        return [_to_python(v) for v in val]
    return obj


def read_rda(path: str) -> Dict[str, Any]:
    """Read a .rda (RData v2/v3) file -> {name: object} dict."""
    with open(path, "rb") as f:
        raw = f.read()
    raw = _decompress(raw)
    if raw[:5] not in (b"RDX3\n", b"RDX2\n"):
        raise ValueError(f"not an RData file: {raw[:5]!r}")
    body = raw[5:]
    return _read_stream(body, is_rda=True)


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00"[:6]:
        import lzma
        return lzma.decompress(raw)
    if raw[:3] == b"BZh":
        import bz2
        return bz2.decompress(raw)
    return raw


def read_rds(path: str):
    with open(path, "rb") as f:
        raw = f.read()
    return _read_stream(_decompress(raw), is_rda=False)


def _read_stream(body: bytes, is_rda: bool):
    if body[:2] != b"X\n":
        raise ValueError("only XDR-format R serialization is supported")
    r = _Reader(body[2:])
    version = r.i32()
    r.i32()                       # writer R version
    r.i32()                       # minimal reader version
    if version >= 3:
        enc_len = r.i32()
        r._take(enc_len)          # native encoding string
    top = r.read_item()
    if not is_rda:
        return _to_python(top)
    out = {}
    node = top
    while isinstance(node, tuple) and node and node[0] == "pairlist":
        _, tag, car, cdr, _ = node
        name = tag[1] if isinstance(tag, tuple) else str(tag)
        out[name] = _to_python(car)
        node = cdr
    return out
