"""SparsePress (.spz) v2 reader/writer — ctypes bindings to the native codec.

The port's copy of ``rcppml_tpu/io/spz.py``: the Python surface of the C++
codec in ``native/streampress.cpp`` (rANS + varint gap coding,
byte-shuffled float streams), mirroring the reference's
``st_write/st_read/st_info/st_read_transpose`` R API (R/streampress.R:
69-760) with scipy CSC matrices.

The codec library is compiled from that same source with ``g++`` (the flags
of ``native/Makefile``) into ``rcppml_tpu_torch/_build/``, under a name
that hashes the source and the flags, at first use; ``native/`` is only
read.  Both packages then encode and decode with one codec source, so their
files agree bit for bit.  If ``g++`` is missing or refuses the source,
:class:`CodecBuildError` is raised: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

CODEC_SOURCE = (Path(__file__).resolve().parent.parent.parent / "native"
                / "streampress.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# native/Makefile: CXXFLAGS ?= -O3 -std=c++17 -fPIC -Wall -Wextra -pthread
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

VALUE_TYPES = {"uint8": 0, "uint16": 1, "uint32": 2, "float32": 3,
               "float16": 4, "quant8": 5, "float64": 6}
VALUE_TYPE_NAMES = {v: k for k, v in VALUE_TYPES.items()}

_lib = None


class CodecBuildError(RuntimeError):
    """g++ is missing, the codec source is missing, or g++ refused it."""


def codec_library_path() -> Path:
    """Where the codec library lives: its name hashes the source and the
    flags, so an edited source is rebuilt and an unchanged one loaded."""
    if not CODEC_SOURCE.exists():
        raise CodecBuildError(f"codec source not found: {CODEC_SOURCE}")
    h = hashlib.sha256(CODEC_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libstreampress_{h.hexdigest()[:16]}.so"


def build_codec() -> Path:
    """Compile ``native/streampress.cpp`` into ``_build/`` unless it is
    built already; returns the library's path."""
    out = codec_library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise CodecBuildError("g++ not found on PATH; the .spz codec is "
                              "compiled from native/streampress.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(CODEC_SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise CodecBuildError(f"{' '.join(cmd)} failed (exit "
                              f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return out


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_codec()))
    lib.spz_last_error.restype = ctypes.c_char_p
    lib.spz_info.restype = ctypes.c_int
    lib.spz_decode.restype = ctypes.c_int
    lib.spz_decode_mt.restype = ctypes.c_int
    lib.spz_encode.restype = ctypes.c_int64
    lib.spz_num_chunks.restype = ctypes.c_int
    lib.spz_chunk_info.restype = ctypes.c_int
    lib.spz_decode_chunk.restype = ctypes.c_int
    lib.spz_encode_v1.restype = ctypes.c_int64
    _lib = lib
    return lib


def _err(lib):
    return lib.spz_last_error().decode()


def _as_buf(data: bytes):
    """Zero-copy uint8* view of a read-only bytes buffer.  The native
    calls only READ through this pointer; from_buffer_copy would double
    resident memory for the lifetime of every open file (streaming
    readers hold it open for the whole fit).  Callers must keep ``data``
    alive across the call — every call site does (local or attribute)."""
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def spz_info_bytes(data: bytes) -> dict:
    lib = _load_lib()
    m = ctypes.c_uint32()
    n = ctypes.c_uint32()
    nnz = ctypes.c_uint64()
    vt = ctypes.c_uint8()
    ht = ctypes.c_uint8()
    buf = _as_buf(data)
    if lib.spz_info(buf, len(data), ctypes.byref(m), ctypes.byref(n),
                    ctypes.byref(nnz), ctypes.byref(vt), ctypes.byref(ht)):
        raise ValueError(f"spz_info: {_err(lib)}")
    ver = int(lib.spz_version(buf, min(len(data), 16)))
    return {"m": m.value, "n": n.value, "nnz": nnz.value,
            "value_type": VALUE_TYPE_NAMES.get(vt.value, vt.value),
            "has_transpose": bool(ht.value), "version": ver}


def _canonical_csc(mat):
    """CSC with sorted, DEDUPLICATED indices — gap coding requires
    strictly increasing rows per column (a duplicate entry would wrap
    the u32 gap; the native encoder also guards this).  Never mutates
    the caller's matrix: tocsc() returns the same object when the input
    is already CSC, so canonicalization works on a copy."""
    mat = mat.tocsc()
    if not mat.has_canonical_format:
        mat = mat.copy()
        mat.sum_duplicates()          # sorts indices too
    return mat


def compress_to_spz_v1_bytes(mat, *, use_delta: bool = True,
                             use_vpred: bool = True) -> bytes:
    """Encode into the LEGACY v1 whole-matrix format (reference
    streampress/sparsepress.hpp:38-425): density-model gap prediction +
    independence value predictor + rANS-escape streams; f64 XOR-delta
    byte-shuffle fallback for non-integer values.  v1 has no chunking and
    no transpose stream — kept for compat with reference-written files."""
    import scipy.sparse as sp
    if not sp.issparse(mat):
        mat = sp.csc_matrix(np.asarray(mat))
    mat = _canonical_csc(mat)
    lib = _load_lib()
    m, n = mat.shape
    p = np.asarray(mat.indptr, dtype=np.int64)
    i = np.asarray(mat.indices, dtype=np.int32)
    x = np.asarray(mat.data, dtype=np.float32)
    pp = p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    ip = i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    xp = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    size = lib.spz_encode_v1(m, n, pp, ip, xp, int(use_delta),
                             int(use_vpred), None, 0)
    if size < 0:
        raise ValueError(f"spz_encode_v1: {_err(lib)}")
    out = np.zeros(size, dtype=np.uint8)
    rc = lib.spz_encode_v1(m, n, pp, ip, xp, int(use_delta), int(use_vpred),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           size)
    if rc < 0:
        raise ValueError(f"spz_encode_v1: {_err(lib)}")
    return out[:rc].tobytes()


def decompress_spz_bytes(data: bytes, transpose: bool = False):
    """Decode a full .spz sparse buffer (v1 or v2) into a scipy CSC matrix."""
    import scipy.sparse as sp
    lib = _load_lib()
    info = spz_info_bytes(data)
    m, n, nnz = info["m"], info["n"], info["nnz"]
    if transpose:
        if not info["has_transpose"]:
            raise ValueError("no transpose stream in this .spz")
        m, n = n, m
    # Trust boundary: header dims are untrusted until the payload decodes.
    # Bound output allocations against the buffer size so a crafted tiny
    # header (v1 allows nnz/n up to 2^32-1) cannot force multi-GB host
    # allocations.  rANS at PROB_BITS=14 cannot sustain anywhere near
    # 64 Ki symbols per payload byte across the gap+value streams, so the
    # generous 65536x multiple never rejects a legitimate file.
    out_bytes = (int(n) + 1) * 8 + int(nnz) * 8
    if out_bytes > max(1 << 24, 65536 * len(data)):
        raise ValueError(
            f"spz header declares n={n}, nnz={nnz} "
            f"({out_bytes / 1e6:.0f} MB decoded) from a {len(data)}-byte "
            "buffer — implausible, refusing to allocate")
    p = np.zeros(n + 1, dtype=np.int64)
    i = np.zeros(nnz, dtype=np.int32)
    x = np.zeros(nnz, dtype=np.float32)
    buf = _as_buf(data)
    # chunk-parallel native decode (serial descriptor pass + thread pool)
    n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.spz_decode_mt(buf, len(data), int(transpose),
                           p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                           x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           int(n_threads))
    if rc:
        raise ValueError(f"spz_decode: {_err(lib)}")
    return sp.csc_matrix((x, i, p), shape=(m, n))


def compress_to_spz_bytes(mat, *, value_type: str = "auto",
                          chunk_cols: int = 2048,
                          with_transpose: bool = True) -> bytes:
    """Encode a scipy sparse / dense matrix into a .spz v2 buffer."""
    import scipy.sparse as sp
    if not sp.issparse(mat):
        mat = sp.csc_matrix(np.asarray(mat))
    mat = _canonical_csc(mat)
    x = np.asarray(mat.data, dtype=np.float32)
    if value_type == "auto":
        # reference auto classification (header_v2.hpp:535-550): smallest
        # unsigned integer type that holds all values, else fp32
        ints = np.all(x == np.round(x)) and np.all(x >= 0)
        mx = x.max(initial=0)
        if ints and mx <= 255:
            value_type = "uint8"
        elif ints and mx <= 65535:
            value_type = "uint16"
        elif ints and mx <= 2 ** 32 - 1:
            value_type = "uint32"
        else:
            value_type = "float32"
    vt = VALUE_TYPES[value_type]

    lib = _load_lib()
    m, n = mat.shape
    p = np.asarray(mat.indptr, dtype=np.int64)
    i = np.asarray(mat.indices, dtype=np.int32)
    pp = p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    ip = i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    xp = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    # single-pass encode into a generous upper-bound buffer: the size
    # query runs the FULL encode, so the two-pass protocol doubled the
    # work.  Bound: headers + descriptors + per-chunk stream framing +
    # rANS worst case (escape coding can exceed raw slightly; byteshuffle
    # adds a few bytes/stream).  Falls back to size-query + exact
    # allocation if the bound is ever insufficient.
    nnz = int(p[n])
    vt_bytes = {0: 1, 1: 2, 2: 4, 3: 4, 4: 2, 5: 1, 6: 8}[vt]
    sides = 2 if with_transpose else 1
    nchunks = sides * (-(-max(m, n) // max(chunk_cols, 1)) + 2)
    bound = (256 + 48 * nchunks + 4096 * nchunks
             + sides * int(nnz * (5.5 + 1.25 * vt_bytes) + (m + n) * 10))
    out = np.zeros(bound, dtype=np.uint8)
    rc = lib.spz_encode(m, n, pp, ip, xp, vt, chunk_cols, int(with_transpose),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        bound)
    if rc < 0:
        # bound too small (or other error): retry with the exact size
        size = lib.spz_encode(m, n, pp, ip, xp, vt, chunk_cols,
                              int(with_transpose), None, 0)
        if size < 0:
            raise ValueError(f"spz_encode: {_err(lib)}")
        out = np.zeros(size, dtype=np.uint8)
        rc = lib.spz_encode(m, n, pp, ip, xp, vt, chunk_cols,
                            int(with_transpose),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            size)
        if rc < 0:
            raise ValueError(f"spz_encode: {_err(lib)}")
    return out[:rc].tobytes()


# ---------------------------------------------------------------------------
# File-level API mirroring R/streampress.R
# ---------------------------------------------------------------------------

def st_write(mat, path: str, *, value_type: str = "auto",
             chunk_cols: int = 2048, with_transpose: bool = True) -> dict:
    data = compress_to_spz_bytes(mat, value_type=value_type,
                                 chunk_cols=chunk_cols,
                                 with_transpose=with_transpose)
    with open(path, "wb") as f:
        f.write(data)
    return spz_info_bytes(data)


def st_read(path: str):
    with open(path, "rb") as f:
        return decompress_spz_bytes(f.read())


def st_read_transpose(path: str):
    with open(path, "rb") as f:
        return decompress_spz_bytes(f.read(), transpose=True)


def st_info(path: str) -> dict:
    with open(path, "rb") as f:
        head = f.read(4096)
        info = spz_info_bytes(head)
        info["file_size"] = os.path.getsize(path)
    return info


class SpzChunkReader:
    """Random-access chunk reader — the DataLoader seam for streaming NMF
    (io/spz_loader.hpp:45).  Keeps the compressed buffer in RAM and decodes
    column panels on demand."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self.data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                self.data = f.read()
        self.lib = _load_lib()
        self.info = spz_info_bytes(self.data)
        self._buf = _as_buf(self.data)

    def num_chunks(self, transpose: bool = False) -> int:
        out = ctypes.c_uint32()
        if self.lib.spz_num_chunks(self._buf, len(self.data), int(transpose),
                                   ctypes.byref(out)):
            raise ValueError(_err(self.lib))
        return out.value

    def chunk_info(self, idx: int, transpose: bool = False):
        """(col_start, n_cols, nnz) of chunk ``idx`` without decoding."""
        cs = ctypes.c_uint32()
        nc = ctypes.c_uint32()
        nz = ctypes.c_uint32()
        if self.lib.spz_chunk_info(self._buf, len(self.data), int(transpose),
                                   idx, ctypes.byref(cs), ctypes.byref(nc),
                                   ctypes.byref(nz)):
            raise ValueError(_err(self.lib))
        return cs.value, nc.value, nz.value

    def chunk_arrays(self, idx: int, transpose: bool = False):
        """Decode chunk ``idx`` -> (col_start, indptr, indices, values)
        raw CSC arrays — no scipy object construction (the streaming
        engine's hot path; scipy's csc_matrix validation is pure-Python
        GIL-held work the Prefetcher workers would serialize on)."""
        cs = ctypes.c_uint32()
        nc = ctypes.c_uint32()
        nz = ctypes.c_uint32()
        if self.lib.spz_chunk_info(self._buf, len(self.data), int(transpose),
                                   idx, ctypes.byref(cs), ctypes.byref(nc),
                                   ctypes.byref(nz)):
            raise ValueError(_err(self.lib))
        p = np.zeros(nc.value + 1, dtype=np.int64)
        i = np.zeros(nz.value, dtype=np.int32)
        x = np.zeros(nz.value, dtype=np.float32)
        if self.lib.spz_decode_chunk(
                self._buf, len(self.data), int(transpose), idx,
                p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
            raise ValueError(_err(self.lib))
        return cs.value, p, i, x

    def chunk(self, idx: int, transpose: bool = False):
        """Decode chunk ``idx`` -> (col_start, csc_submatrix)."""
        import scipy.sparse as sp
        cs, p, i, x = self.chunk_arrays(idx, transpose)
        rows = self.info["n"] if transpose else self.info["m"]
        sub = sp.csc_matrix((x, i, p), shape=(rows, len(p) - 1))
        return cs, sub


# ---------------------------------------------------------------------------
# v3 dense column-panel format (format/header_v3.hpp)
# ---------------------------------------------------------------------------

DENSE_CODECS = {"raw": 0, "raw_fp32": 0, "none": 0, "fp16": 1}
DENSE_CODEC_NAMES = {0: "raw", 1: "fp16"}


def spz_version_bytes(data: bytes) -> int:
    lib = _load_lib()
    return int(lib.spz_version(_as_buf(data[:16]), min(len(data), 16)))


def compress_dense_to_spz_bytes(A, *, codec: str = "raw",
                                chunk_cols: int = 2048,
                                with_transpose: bool = True) -> bytes:
    """Encode a dense (m, n) matrix into a v3 buffer (st_write_dense)."""
    lib = _load_lib()
    lib.spz3_encode.restype = ctypes.c_int64
    A = np.asarray(A, dtype=np.float32)
    m, n = A.shape
    col_major = np.asfortranarray(A).ravel(order="F")
    cp = col_major.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    cd = DENSE_CODECS[codec]
    # single-pass: the size query re-runs the whole encode; v3 sizes are
    # deterministic (raw fp32 / fp16 panels + fixed framing), so bound
    # exactly with slack and fall back only on error
    sides = 2 if with_transpose else 1
    per_val = 2 if codec == "fp16" else 4
    nchunks = sides * (-(-max(m, n) // max(chunk_cols, 1)) + 2)
    bound = 256 + 64 * nchunks + sides * (int(m) * int(n) * per_val) + 4096
    out = np.zeros(bound, dtype=np.uint8)
    rc = lib.spz3_encode(m, n, cp, cd, chunk_cols, int(with_transpose),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         bound)
    if rc < 0:
        size = lib.spz3_encode(m, n, cp, cd, chunk_cols, int(with_transpose),
                               None, 0)
        if size < 0:
            raise ValueError(f"spz3_encode: {_err(lib)}")
        out = np.zeros(size, dtype=np.uint8)
        rc = lib.spz3_encode(m, n, cp, cd, chunk_cols, int(with_transpose),
                             out.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_uint8)),
                             size)
    if rc < 0:
        raise ValueError(f"spz3_encode: {_err(lib)}")
    return out[:rc].tobytes()


def decompress_dense_spz_bytes(data: bytes, transpose: bool = False):
    """Decode a v3 buffer into a dense (m, n) float32 array."""
    lib = _load_lib()
    m = ctypes.c_uint32()
    n = ctypes.c_uint32()
    ht = ctypes.c_uint8()
    cd = ctypes.c_uint8()
    buf = _as_buf(data)
    if lib.spz3_info(buf, len(data), ctypes.byref(m), ctypes.byref(n),
                     ctypes.byref(ht), ctypes.byref(cd)):
        raise ValueError(f"spz3_info: {_err(lib)}")
    rows, cols = (n.value, m.value) if transpose else (m.value, n.value)
    out = np.zeros(rows * cols, dtype=np.float32)
    if lib.spz3_decode(buf, len(data), int(transpose),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        raise ValueError(f"spz3_decode: {_err(lib)}")
    return out.reshape((cols, rows)).T   # stored column-major


def st_write_dense(A, path: str, *, codec: str = "raw",
                   chunk_cols: int = 2048, with_transpose: bool = True):
    """R/streampress.R st_write_dense — dense v3 panels."""
    data = compress_dense_to_spz_bytes(A, codec=codec, chunk_cols=chunk_cols,
                                       with_transpose=with_transpose)
    with open(path, "wb") as f:
        f.write(data)
    return {"m": A.shape[0], "n": A.shape[1], "version": 3,
            "file_size": len(data)}


def st_read_dense(path: str, transpose: bool = False):
    with open(path, "rb") as f:
        return decompress_dense_spz_bytes(f.read(), transpose=transpose)


def st_read_auto(path: str):
    """Version-detecting read (detect_version in fit_streaming_spz.hpp:66-93):
    v2 -> scipy CSC, v3 -> dense ndarray."""
    with open(path, "rb") as f:
        data = f.read()
    ver = spz_version_bytes(data)
    if ver in (1, 2):
        return decompress_spz_bytes(data)
    if ver == 3:
        return decompress_dense_spz_bytes(data)
    raise ValueError(f"unsupported spz version {ver}")


def st_add_transpose(path: str) -> None:
    """Rewrite a .spz with an embedded transpose stream (st_add_transpose).

    The original encoding parameters survive the rewrite: v2 keeps its
    value_type and chunk geometry, v3 its codec — re-encoding with
    defaults would silently change the file's size/precision contract."""
    with open(path, "rb") as f:
        data = f.read()
    ver = spz_version_bytes(data)
    if ver == 2:
        info = spz_info_bytes(data)
        r = SpzChunkReader(data)
        chunk_cols = 2048
        if r.num_chunks():
            _, nc0, _ = r.chunk_info(0)
            chunk_cols = int(nc0)
        mat = decompress_spz_bytes(data)
        vt = info["value_type"]
        with open(path, "wb") as f:
            f.write(compress_to_spz_bytes(
                mat, value_type=vt if isinstance(vt, str) else "auto",
                chunk_cols=chunk_cols, with_transpose=True))
    elif ver == 3:
        lib = _load_lib()
        m_ = ctypes.c_uint32(); n_ = ctypes.c_uint32()
        ht_ = ctypes.c_uint8(); cd_ = ctypes.c_uint8()
        buf = _as_buf(data)
        if lib.spz3_info(buf, len(data), ctypes.byref(m_), ctypes.byref(n_),
                         ctypes.byref(ht_), ctypes.byref(cd_)):
            raise ValueError(f"spz3_info: {_err(lib)}")
        codec = DENSE_CODEC_NAMES.get(cd_.value, "raw")
        dense = decompress_dense_spz_bytes(data)
        with open(path, "wb") as f:
            f.write(compress_dense_to_spz_bytes(dense, codec=codec,
                                                with_transpose=True))
    else:
        raise ValueError(f"unsupported spz version {ver}")


# ---------------------------------------------------------------------------
# st_convert — foreign formats -> .spz (R/streampress.R st_convert)
# ---------------------------------------------------------------------------

def st_convert(src: str, dst: str, *, value_type: str = "auto",
               with_transpose: bool = True, **kw) -> dict:
    """Convert .mtx / .csv / .h5ad / .loom / .h5 to SparsePress v2."""
    import scipy.sparse as sp
    lower = src.lower()
    if lower.endswith(".mtx") or lower.endswith(".mtx.gz"):
        from scipy.io import mmread
        mat = mmread(src).tocsc()
    elif lower.endswith(".csv") or lower.endswith(".csv.gz"):
        mat = sp.csc_matrix(np.loadtxt(src, delimiter=",", ndmin=2))
    elif lower.endswith(".h5ad"):
        mat = _read_h5ad_x(src)
    elif lower.endswith(".loom"):
        mat = _read_loom(src)
    elif lower.endswith(".h5"):
        mat = _read_10x_h5(src)
    else:
        raise ValueError(f"unsupported source format: {src}")
    return st_write(mat, dst, value_type=value_type,
                    with_transpose=with_transpose, **kw)


def _read_h5ad_x(path: str):
    """Minimal AnnData X reader: genes x cells CSC (transposing AnnData's
    cells x genes layout to the reference's convention)."""
    import h5py
    import scipy.sparse as sp
    with h5py.File(path, "r") as f:
        X = f["X"]
        if isinstance(X, h5py.Dataset):
            return sp.csc_matrix(np.asarray(X).T)
        enc = X.attrs.get("encoding-type", b"")
        enc = enc.decode() if isinstance(enc, bytes) else enc
        data = np.asarray(X["data"])
        indices = np.asarray(X["indices"])
        indptr = np.asarray(X["indptr"])
        shape = tuple(X.attrs["shape"])
        if "csr" in enc:
            mat = sp.csr_matrix((data, indices, indptr), shape=shape)
        else:
            mat = sp.csc_matrix((data, indices, indptr), shape=shape)
        return mat.T.tocsc()


def _read_loom(path: str):
    import h5py
    import scipy.sparse as sp
    with h5py.File(path, "r") as f:
        return sp.csc_matrix(np.asarray(f["matrix"]))


def _read_10x_h5(path: str):
    import h5py
    import scipy.sparse as sp
    with h5py.File(path, "r") as f:
        grp = None
        for key in f.keys():
            if isinstance(f[key], h5py.Group) and "data" in f[key]:
                grp = f[key]
                break
        if grp is None:
            raise ValueError("no CSC group found in .h5")
        shape = tuple(np.asarray(grp["shape"]))
        return sp.csc_matrix((np.asarray(grp["data"]),
                              np.asarray(grp["indices"]),
                              np.asarray(grp["indptr"])), shape=shape)


# ---------------------------------------------------------------------------
# obs/var tables + dimnames (R/streampress.R st_read_obs/st_read_var)
# ---------------------------------------------------------------------------

def _read_table_for_axis(path: str, axis_len_of) -> dict:
    """Read whichever obs/var table slot annotates the requested axis
    (tables self-describe their row count; the reference writer has been
    observed to place the per-column table in either slot)."""
    import struct
    from .spz_meta import read_obs_var_table, v2_table_offsets
    with open(path, "rb") as f:
        data = f.read()
    m, n = struct.unpack_from("<II", data, 8)
    want = axis_len_of(m, n)
    for off in v2_table_offsets(data)[:2]:
        if off:
            tbl = read_obs_var_table(data, off)
            if tbl and len(next(iter(tbl.values()))) == want:
                return tbl
    return {}


def st_read_obs(path: str):
    """Per-column (cell) metadata table -> {name: array}."""
    return _read_table_for_axis(path, lambda m, n: n)


def st_read_var(path: str):
    """Per-row (gene/feature) metadata table -> {name: array}."""
    return _read_table_for_axis(path, lambda m, n: m)


def st_read_dimnames(path: str) -> dict:
    from .spz_meta import read_metadata, v2_table_offsets
    with open(path, "rb") as f:
        data = f.read()
    _, _, meta_off = v2_table_offsets(data)
    return read_metadata(data, meta_off)


def st_write_with_metadata(mat, path: str, *, obs=None, var=None,
                           rownames=None, colnames=None, **kw) -> dict:
    """st_write plus obs/var tables and dimnames attached."""
    from .spz_meta import attach_to_v2
    data = compress_to_spz_bytes(mat, **kw)
    data = attach_to_v2(data, obs=obs, var=var, rownames=rownames,
                        colnames=colnames)
    with open(path, "wb") as f:
        f.write(data)
    return spz_info_bytes(data)


# ---------------------------------------------------------------------------
# Slicing / chunk mapping / metadata filters (R/streampress.R:488-760)
# ---------------------------------------------------------------------------

def st_chunk_ranges(path, transpose: bool = False):
    """Column ranges per chunk as a list of 0-based half-open ``(start, end)``
    tuples (R/streampress.R:583 is 1-based inclusive)."""
    r = SpzChunkReader(path)
    out = []
    for idx in range(r.num_chunks(transpose)):
        cs, nc, _ = r.chunk_info(idx, transpose)
        out.append((int(cs), int(cs) + int(nc)))
    return out


def _slice_cols_reader(r: "SpzChunkReader", cols, transpose: bool):
    """Decode only the chunks covering ``cols`` — chunk-level random access
    instead of the reference's full-file read (R/streampress.R:496-501)."""
    import scipy.sparse as sp
    cols = np.asarray(cols, dtype=np.int64)
    decoded = {}          # chunk idx -> (col_start, csc)
    ranges = []           # (lo, hi, idx) from header info only
    for idx in range(r.num_chunks(transpose)):
        cs, nc, _ = r.chunk_info(idx, transpose)
        ranges.append((int(cs), int(cs) + int(nc), idx))
    pieces = []
    for c in cols:
        for lo, hi, idx in ranges:
            if lo <= c < hi:
                if idx not in decoded:
                    decoded[idx] = r.chunk(idx, transpose)
                lo_d, sub = decoded[idx]
                pieces.append(sub[:, int(c - lo_d)])
                break
        else:
            raise IndexError(f"column {int(c)} out of range")
    return sp.hstack(pieces, format="csc")


def st_slice_cols(path, cols):
    """Read a subset of columns (0-based) from a .spz file."""
    return _slice_cols_reader(SpzChunkReader(path), cols, transpose=False)


def st_slice_rows(path, rows):
    """Read a subset of rows via the pre-stored transpose stream — requires
    ``include_transpose`` at write time (R/streampress.R:522-529)."""
    r = SpzChunkReader(path)
    if r.num_chunks(True) == 0:
        raise ValueError("file has no transpose stream; rewrite with "
                         "with_transpose=True or use st_read + row slicing")
    return _slice_cols_reader(r, rows, transpose=True).T.tocsc()


def st_slice(path, rows=None, cols=None):
    """Row and/or column slice (R/streampress.R:549-557)."""
    import scipy.sparse as sp
    if cols is not None and rows is not None:
        A = st_slice_cols(path, cols)
        return A[np.asarray(rows, dtype=np.int64)].tocsc()
    if cols is not None:
        return st_slice_cols(path, cols)
    if rows is not None:
        return st_slice_rows(path, rows)
    return st_read(path)


def st_map_chunks(path, fn, transpose: bool = False):
    """Apply ``fn(chunk_csc, start, end)`` to each column-panel without ever
    materializing the full matrix (R/streampress.R:613-634); returns the list
    of per-chunk results."""
    r = SpzChunkReader(path)
    out = []
    for idx in range(r.num_chunks(transpose)):
        cs, sub = r.chunk(idx, transpose)
        out.append(fn(sub, int(cs), int(cs) + sub.shape[1]))
    return out


def _filter_indices(table: dict, predicate) -> np.ndarray:
    """predicate: callable(table_dict) -> bool mask, or {col: value} equality
    dict (the Python analog of R's subset() expressions)."""
    if not table:
        raise ValueError("file has no metadata table")
    if callable(predicate):
        mask = np.asarray(predicate(table), dtype=bool)
    else:
        if not predicate:
            raise ValueError("empty filter predicate")
        mask = None
        for col, val in predicate.items():
            m = np.asarray(table[col]) == val
            mask = m if mask is None else (mask & m)
    return np.flatnonzero(mask)


def st_obs_indices(path, predicate) -> np.ndarray:
    """Indices into the obs table matching a filter (R/streampress.R:657-663).

    obs is per-COLUMN metadata (cells) in the format
    (format/obs_var_table.hpp), so these index columns.  The reference's R
    wrapper feeds them to a row slice, contradicting its own writer
    (R/streampress.R:753 ``obs nrow == total cols``); here the axes follow
    the format."""
    return _filter_indices(st_read_obs(path), predicate)


def st_filter_cols(path, predicate):
    """Slice columns whose obs entries match, e.g.
    ``st_filter_cols(p, {"cell_type": "B cell"})``."""
    idx = st_obs_indices(path, predicate)
    if idx.size == 0:
        raise ValueError("no columns match filter criteria")
    return st_slice_cols(path, idx)


def st_filter_rows(path, predicate):
    """Slice rows whose var (per-row, e.g. gene) entries match."""
    idx = _filter_indices(st_read_var(path), predicate)
    if idx.size == 0:
        raise ValueError("no rows match filter criteria")
    return st_slice_rows(path, idx)


def st_write_list(mats, path: str, *, obs=None, var=None, **kw) -> dict:
    """Column-concatenate matrices and write one .spz
    (R/streampress.R:741-760); all matrices must share nrow."""
    import scipy.sparse as sp
    mats = [m if sp.issparse(m) else sp.csc_matrix(np.asarray(m, np.float32))
            for m in mats]
    nr = mats[0].shape[0]
    if any(m.shape[0] != nr for m in mats):
        raise ValueError("all matrices must have the same number of rows")
    combined = sp.hstack(mats, format="csc")
    if obs is not None or var is not None:
        return st_write_with_metadata(combined, path, obs=obs, var=var, **kw)
    st_write(combined, path, **kw)
    return st_info(path)


def st_read_device(path, *, transpose: bool = False, device=None):
    """Decode a .spz straight into device memory as a dense float32
    ``torch.Tensor`` — the analog of the reference's zero-copy GPU read
    (R/sp_gpu.R:48-126, st_read_gpu).  ``device``: the CUDA card by
    default; the tensor feeds nmf()/svd() with no re-upload."""
    import torch
    sp = st_read_auto(path)
    if transpose:
        sp = sp.T
    # v2 returns scipy CSC (todense); v3 returns a dense ndarray already
    dense = np.ascontiguousarray(
        sp.todense() if hasattr(sp, "todense") else sp, dtype=np.float32)
    return torch.from_numpy(dense).to(
        torch.device("cuda") if device is None else torch.device(device))


def st_free_device(x) -> None:
    """Release a device tensor's memory eagerly — the analog of the
    reference's ``st_free_gpu`` (R/sp_gpu.R:118-126).  The tensor's storage
    is emptied (the tensor becomes size 0) and the caching allocator's
    free blocks return to the card.  No-op for anything that is not a
    tensor (e.g. a numpy array)."""
    import torch
    if not isinstance(x, torch.Tensor):
        return
    on_cuda = x.is_cuda
    x.data = torch.empty(0, dtype=x.dtype, device=x.device)
    if on_cuda:
        torch.cuda.empty_cache()
