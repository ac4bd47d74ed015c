"""Obs/var metadata tables + dimnames for .spz files.

Pure-Python implementation of the reference's binary column-store tables
(streampress/format/obs_var_table.hpp: 16-byte OVTB header + 112-byte
column descriptors + raw blobs) and the self-describing metadata section
(header_v2.hpp:289-431: ROWNAMES/COLNAMES null-delimited strings,
ROW_PERMUTATION uint32 array).  Reads tables written by the reference
encoder (e.g. the pbmc3k fixture's var table) and writes tables the
reference can read.

The port's own copy of ``rcppml_tpu/io/spz_meta.py`` (pure numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

_OVTB = b"OVTB"
_COL_DESC_SIZE = 112
_NA_INT32 = -2147483648
_NA_UINT32 = 0xFFFFFFFF
_NA_BOOL = 255

# ColType enum (obs_var_table.hpp:46-53)
_INT32, _FLOAT32, _FLOAT64, _BOOL, _UINT32, _STRING_DICT = range(6)


def read_obs_var_table(buf: bytes, offset: int) -> Dict[str, np.ndarray]:
    """Parse an OVTB table at ``offset`` -> {column_name: array}."""
    if offset == 0 or offset + 16 > len(buf):
        return {}
    magic, n_rows, n_cols, header_bytes = struct.unpack_from("<4sIII", buf,
                                                             offset)
    if magic != _OVTB:
        raise ValueError("bad obs/var table magic")
    out: Dict[str, np.ndarray] = {}
    # column data offsets are relative to the TABLE START (the reference's
    # first blob sits exactly at header_bytes — verified against the
    # pbmc3k fixture written by the reference encoder)
    blob_base = offset
    for c in range(n_cols):
        d0 = offset + 16 + c * _COL_DESC_SIZE
        name = buf[d0:d0 + 64].split(b"\0")[0].decode("utf-8",
                                                      errors="replace")
        col_type, nullable = struct.unpack_from("<BB", buf, d0 + 64)
        dict_bytes, = struct.unpack_from("<I", buf, d0 + 68)
        data_off, dict_off = struct.unpack_from("<QQ", buf, d0 + 72)
        start = blob_base + data_off
        if col_type == _INT32:
            arr = np.frombuffer(buf, "<i4", n_rows, start).copy()
        elif col_type == _FLOAT32:
            arr = np.frombuffer(buf, "<f4", n_rows, start).copy()
        elif col_type == _FLOAT64:
            arr = np.frombuffer(buf, "<f8", n_rows, start).copy()
        elif col_type == _BOOL:
            raw = np.frombuffer(buf, "u1", n_rows, start)
            arr = np.where(raw == _NA_BOOL, -1, raw).astype(np.int8)
        elif col_type == _UINT32:
            arr = np.frombuffer(buf, "<u4", n_rows, start).copy()
        elif col_type == _STRING_DICT:
            codes = np.frombuffer(buf, "<u4", n_rows, start)
            dstart = blob_base + dict_off
            raw_levels = buf[dstart:dstart + dict_bytes].split(b"\0")[:-1]
            levels = [s.decode("utf-8", errors="replace") for s in raw_levels]
            vals = np.empty(n_rows, dtype=object)
            for i, code in enumerate(codes):
                vals[i] = None if code == _NA_UINT32 else (
                    levels[code] if code < len(levels) else None)
            arr = vals
        else:
            continue
        out[name] = arr
    return out


def serialize_obs_var_table(columns: Dict[str, np.ndarray],
                            n_rows: int) -> bytes:
    """Serialize {name: array} into the OVTB wire format."""
    descs = []
    blobs = []
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if len(arr) != n_rows:
            raise ValueError(f"column {name!r}: length {len(arr)} != {n_rows}")
        dict_blob = b""
        if arr.dtype == object or arr.dtype.kind in "US":
            svals = ["" if v is None else str(v) for v in arr]
            levels = sorted(set(svals))
            index = {s: i for i, s in enumerate(levels)}
            codes = np.asarray([index[s] for s in svals], dtype="<u4")
            data = codes.tobytes()
            dict_blob = b"".join(s.encode() + b"\0" for s in levels)
            ct = _STRING_DICT
        elif arr.dtype.kind == "b":
            data = arr.astype("u1").tobytes()
            ct = _BOOL
        elif arr.dtype.kind == "u":
            data = arr.astype("<u4").tobytes()
            ct = _UINT32
        elif arr.dtype.kind == "i":
            data = arr.astype("<i4").tobytes()
            ct = _INT32
        elif arr.dtype == np.float32:
            data = arr.astype("<f4").tobytes()
            ct = _FLOAT32
        else:
            data = arr.astype("<f8").tobytes()
            ct = _FLOAT64
        descs.append((name, ct, len(dict_blob)))
        blobs.append((data, dict_blob))

    header_bytes = 16 + len(descs) * _COL_DESC_SIZE
    out = bytearray()
    out += struct.pack("<4sIII", _OVTB, n_rows, len(descs), header_bytes)
    data_cursor = header_bytes              # offsets relative to table start
    desc_bytes = bytearray()
    blob_bytes = bytearray()
    for (name, ct, dict_len), (data, dict_blob) in zip(descs, blobs):
        nm = name.encode("utf-8")[:63]
        d = bytearray(_COL_DESC_SIZE)
        d[:len(nm)] = nm
        struct.pack_into("<BB", d, 64, ct, 0)
        struct.pack_into("<I", d, 68, dict_len)
        struct.pack_into("<QQ", d, 72, data_cursor,
                         data_cursor + len(data) if dict_len else 0)
        desc_bytes += d
        blob_bytes += data
        data_cursor += len(data)
        if dict_blob:
            blob_bytes += dict_blob
            data_cursor += len(dict_blob)
    out += desc_bytes
    out += blob_bytes
    return bytes(out)


# ---------------------------------------------------------------------------
# Metadata section (dimnames / row permutation)
# ---------------------------------------------------------------------------

_KEY_ROWNAMES, _KEY_COLNAMES, _KEY_ROW_PERM, _KEY_CUSTOM = range(4)


def read_metadata(buf: bytes, offset: int, avail: Optional[int] = None) -> dict:
    """Parse the metadata section (header_v2.hpp:433+)."""
    if offset == 0 or offset + 4 > len(buf):
        return {}
    n, = struct.unpack_from("<I", buf, offset)
    pos = offset + 4
    out = {}
    for _ in range(n):
        key = buf[pos]
        pos += 1
        length, = struct.unpack_from("<I", buf, pos)
        pos += 4
        data = buf[pos:pos + length]
        pos += length
        if key in (_KEY_ROWNAMES, _KEY_COLNAMES):
            names = [s.decode("utf-8", errors="replace")
                     for s in data.split(b"\0")[:-1]]
            out["rownames" if key == _KEY_ROWNAMES else "colnames"] = names
        elif key == _KEY_ROW_PERM:
            out["row_permutation"] = np.frombuffer(data, "<u4").copy()
    return out


def serialize_metadata(rownames=None, colnames=None, row_permutation=None) -> bytes:
    entries = []
    if rownames is not None:
        entries.append((_KEY_ROWNAMES,
                        b"".join(str(s).encode() + b"\0" for s in rownames)))
    if colnames is not None:
        entries.append((_KEY_COLNAMES,
                        b"".join(str(s).encode() + b"\0" for s in colnames)))
    if row_permutation is not None:
        entries.append((_KEY_ROW_PERM,
                        np.asarray(row_permutation, "<u4").tobytes()))
    out = bytearray(struct.pack("<I", len(entries)))
    for key, data in entries:
        out += struct.pack("<BI", key, len(data))
        out += data
    return bytes(out)


# ---------------------------------------------------------------------------
# v2 buffer surgery: attach tables / metadata (header reserved fields)
# ---------------------------------------------------------------------------

def attach_to_v2(buf: bytes, *, obs: Optional[Dict] = None,
                 var: Optional[Dict] = None, rownames=None,
                 colnames=None) -> bytes:
    """Insert obs/var tables and/or dimnames into an encoded v2 buffer.

    Sections go before the 16-byte footer; the header's reserved obs/var
    offsets (header_v2.hpp:173-186) and metadata_offset are patched.
    """
    import zlib
    m, n = struct.unpack_from("<II", buf, 8)
    body = bytearray(buf[:-16])
    footer = bytearray(buf[-16:])
    meta_size = 0
    if obs:
        struct.pack_into("<Q", body, 96, len(body))
        body += serialize_obs_var_table(obs, n)
    if var:
        struct.pack_into("<Q", body, 104, len(body))
        body += serialize_obs_var_table(var, m)
    if rownames is not None or colnames is not None:
        struct.pack_into("<Q", body, 80, len(body))     # metadata_offset
        meta = serialize_metadata(rownames=rownames, colnames=colnames)
        body += meta
        meta_size = len(meta)
        body[116] |= 0x01                               # has_dimnames flag
    # rebuild the footer: metadata_size + file_crc32 over everything
    # before the footer (Footer_v2, header_v2.hpp:251-262)
    struct.pack_into("<II", footer, 0, meta_size,
                     zlib.crc32(bytes(body)) & 0xFFFFFFFF)
    return bytes(body) + bytes(footer)


def v2_table_offsets(buf: bytes):
    obs_off, var_off = struct.unpack_from("<QQ", buf, 96)
    meta_off, = struct.unpack_from("<Q", buf, 80)
    return obs_off, var_off, meta_off
