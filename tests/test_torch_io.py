"""The port's ``.spz`` codec, R data reader, panel loaders and dataset
loaders (``rcppml_tpu_torch/io/``, ``datasets.py``, ``utils/resources.py``)
against the JAX package's, on the CPU.

* Codec: for every value type, v1 and v2, with and without the transpose
  stream, with obs / var tables and dimnames, and the dense v3 panels, the
  port's bytes equal the JAX package's bit for bit; each package reads the
  other's file into equal arrays; a corrupt file raises the same error.
  Both compile ``native/streampress.cpp`` (the port into its own
  ``_build/``, with ``g++``).
* Loaders: dense and COO panels, forward and transposed, equal to the JAX
  loaders'; the Prefetcher keeps panel order; CachingLoader caches.
* The densify of the streaming engine widens uint16 rows and values
  exactly (indices and values past 32767).
* ``datasets`` raises the JAX package's missing-file error; ``load_data``
  reads what the JAX one reads; ``rdata`` parses a small XDR object
  assembled here as the JAX reader does.
"""

import gzip
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rcppml_tpu import datasets as ref_datasets
from rcppml_tpu.io import loaders as ref_loaders
from rcppml_tpu.io import rdata as ref_rdata
from rcppml_tpu.io import spz as ref_spz
from rcppml_tpu.utils import resources as ref_resources

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import datasets
from rcppml_tpu_torch.io import loaders, rdata, spz
from rcppml_tpu_torch.io.panels import _compact_sparse
from rcppml_tpu_torch.io.upload import upload
from rcppml_tpu_torch.ops import coo_densify
from rcppml_tpu_torch.utils import resources

REPO = Path(__file__).resolve().parent.parent
VALUE_TYPES = ("uint8", "uint16", "uint32", "float32", "float16", "quant8",
               "float64")


def _matrix(value_type, m=70, n=90, density=0.2, seed=0):
    """A sparse CSC matrix whose values suit ``value_type``: integers in
    range for the unsigned types (uint16 past 32767), reals otherwise."""
    rs = np.random.RandomState(seed)
    A = sp.random(m, n, density=density, random_state=rs, format="csc",
                  dtype=np.float64)
    top = {"uint8": 255, "uint16": 60000, "uint32": 3_000_000}.get(
        value_type)
    if top is not None:
        A.data = np.ceil(A.data * top)
    else:
        A.data = (A.data * 10.0 - 2.0)
    return A.astype(np.float32)


def _same_csc(a, b):
    a, b = a.tocsc(), b.tocsc()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def test_codec_library_is_built_from_the_repo_source():
    """The port compiles native/streampress.cpp into its own _build/, under
    a name that hashes the source and flags, and never loads or writes the
    JAX package's native/libstreampress.so."""
    path = spz.codec_library_path()
    lib = spz._load_lib()
    assert Path(lib._name) == path
    assert path.parent == REPO / "rcppml_tpu_torch" / "_build"
    assert path.name.startswith("libstreampress_") and path.exists()
    assert spz.CODEC_SOURCE == REPO / "native" / "streampress.cpp"


@pytest.mark.parametrize("with_transpose", [True, False])
@pytest.mark.parametrize("value_type", VALUE_TYPES)
def test_v2_bytes_and_cross_reads(value_type, with_transpose, tmp_path):
    A = _matrix(value_type)
    mine = spz.compress_to_spz_bytes(A, value_type=value_type,
                                     chunk_cols=32,
                                     with_transpose=with_transpose)
    ref = ref_spz.compress_to_spz_bytes(A, value_type=value_type,
                                        chunk_cols=32,
                                        with_transpose=with_transpose)
    assert mine == ref
    p_mine, p_ref = tmp_path / "port.spz", tmp_path / "ref.spz"
    info = rtt.st_write(A, str(p_mine), value_type=value_type,
                        chunk_cols=32, with_transpose=with_transpose)
    ref_info = ref_spz.st_write(A, str(p_ref), value_type=value_type,
                                chunk_cols=32, with_transpose=with_transpose)
    assert info == ref_info
    assert p_mine.read_bytes() == p_ref.read_bytes()
    # each package reads the other's file, into equal matrices
    _same_csc(rtt.st_read(str(p_ref)), ref_spz.st_read(str(p_ref)))
    _same_csc(ref_spz.st_read(str(p_mine)), rtt.st_read(str(p_mine)))
    assert rtt.st_info(str(p_ref)) == ref_spz.st_info(str(p_mine))
    if with_transpose:
        _same_csc(rtt.st_read_transpose(str(p_ref)),
                  ref_spz.st_read_transpose(str(p_mine)))
    if value_type in ("uint8", "uint16", "uint32", "float32", "float64"):
        # the lossless types read back the source bit for bit
        _same_csc(rtt.st_read(str(p_ref)), A)


@pytest.mark.parametrize("use_delta,use_vpred", [(True, True), (False, False),
                                                 (True, False)])
def test_v1_bytes_and_cross_reads(use_delta, use_vpred, tmp_path):
    A = _matrix("uint16", seed=3)
    mine = spz.compress_to_spz_v1_bytes(A, use_delta=use_delta,
                                        use_vpred=use_vpred)
    ref = ref_spz.compress_to_spz_v1_bytes(A, use_delta=use_delta,
                                           use_vpred=use_vpred)
    assert mine == ref
    _same_csc(spz.decompress_spz_bytes(ref), ref_spz.decompress_spz_bytes(
        mine))
    _same_csc(spz.decompress_spz_bytes(mine), A)


@pytest.mark.parametrize("codec,with_transpose", [("raw", True),
                                                  ("raw", False),
                                                  ("fp16", True)])
def test_v3_dense_bytes_and_cross_reads(codec, with_transpose, tmp_path):
    A = np.random.RandomState(4).rand(40, 70).astype(np.float32)
    p_mine, p_ref = tmp_path / "port.spz", tmp_path / "ref.spz"
    rtt.st_write_dense(A, str(p_mine), codec=codec, chunk_cols=16,
                       with_transpose=with_transpose)
    ref_spz.st_write_dense(A, str(p_ref), codec=codec, chunk_cols=16,
                           with_transpose=with_transpose)
    assert p_mine.read_bytes() == p_ref.read_bytes()
    got = rtt.st_read_dense(str(p_ref))
    assert np.array_equal(got, ref_spz.st_read_dense(str(p_mine)))
    assert np.array_equal(rtt.st_read_auto(str(p_ref)),
                          ref_spz.st_read_auto(str(p_mine)))
    if codec == "raw":
        assert np.array_equal(got, A)


@pytest.mark.parametrize("value_type", ["uint16", "float32"])
def test_metadata_bytes_and_cross_reads(value_type, tmp_path):
    A = _matrix(value_type, m=30, n=40, seed=5)
    obs = {"cell_type": np.asarray(["B", "T", "NK", "B"] * 10),
           "depth": np.arange(40, dtype=np.float64)}
    var = {"gene_id": np.arange(30, dtype=np.int32)}
    rows = [f"g{i}" for i in range(30)]
    cols = [f"c{j}" for j in range(40)]
    p_mine, p_ref = tmp_path / "port.spz", tmp_path / "ref.spz"
    rtt.st_write_with_metadata(A, str(p_mine), obs=obs, var=var,
                               rownames=rows, colnames=cols,
                               value_type=value_type, chunk_cols=16)
    ref_spz.st_write_with_metadata(A, str(p_ref), obs=obs, var=var,
                                   rownames=rows, colnames=cols,
                                   value_type=value_type, chunk_cols=16)
    assert p_mine.read_bytes() == p_ref.read_bytes()
    for mine, ref in ((rtt.st_read_obs(str(p_ref)),
                       ref_spz.st_read_obs(str(p_mine))),
                      (rtt.st_read_var(str(p_ref)),
                       ref_spz.st_read_var(str(p_mine)))):
        assert sorted(mine) == sorted(ref)
        for key in ref:
            assert np.array_equal(np.asarray(mine[key]),
                                  np.asarray(ref[key]))
    dn, ref_dn = (rtt.st_read_dimnames(str(p_ref)),
                  ref_spz.st_read_dimnames(str(p_mine)))
    assert {k: list(v) if v is not None else None for k, v in dn.items()} \
        == {k: list(v) if v is not None else None for k, v in ref_dn.items()}
    # slicing and filters read the same panels
    _same_csc(rtt.st_filter_cols(str(p_ref), {"cell_type": "B"}),
              ref_spz.st_filter_cols(str(p_mine), {"cell_type": "B"}))
    _same_csc(rtt.st_slice(str(p_ref), rows=[1, 5, 7], cols=[0, 3, 39]),
              ref_spz.st_slice(str(p_mine), rows=[1, 5, 7], cols=[0, 3, 39]))
    assert rtt.st_chunk_ranges(str(p_ref)) == \
        ref_spz.st_chunk_ranges(str(p_mine))


def test_corrupt_file_raises_the_same_error(tmp_path):
    A = _matrix("uint16", seed=6)
    data = bytearray(ref_spz.compress_to_spz_bytes(A, chunk_cols=32))
    data[len(data) // 2] ^= 0xFF
    errors = []
    for mod in (loaders, ref_loaders):
        with pytest.raises(ValueError) as exc:
            mod.SpzLoader(bytes(data))
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and errors[0].startswith("corrupt .spz")


def test_st_names_resolve_as_in_the_jax_package():
    import rcppml_tpu as rt
    for name in rtt._ST_NAMES:
        assert callable(getattr(rtt, name)), name
        assert name in rt._ST_NAMES
    assert set(rtt._ST_NAMES) == set(rt._ST_NAMES)
    for name in ("st_read_gpu", "st_free_gpu", "st_free_device",
                 "streaming_svd", "nnls_streaming", "load_data",
                 "datasets"):
        assert getattr(rtt, name) is not None, name
    assert rtt.st_read_gpu is rtt.st_read_device
    assert rtt.st_free_gpu is rtt.st_free_device


def test_st_read_device_and_free(tmp_path):
    A = _matrix("float32", seed=7)
    path = str(tmp_path / "a.spz")
    rtt.st_write(A, path)
    X = rtt.st_read_device(path, device="cpu")
    assert isinstance(X, torch.Tensor) and X.dtype == torch.float32
    assert np.array_equal(X.numpy(), A.toarray())
    Xt = rtt.st_read_device(path, transpose=True, device="cpu")
    assert np.array_equal(Xt.numpy(), A.toarray().T)
    rtt.st_free_device(X)
    assert X.numel() == 0
    rtt.st_free_device(np.zeros(3))          # no-op for a host array


def test_import_guard_scans_the_io_modules():
    """The import guard of tests/test_torch_ops.py scans every port
    source; importing the io modules loads neither jax nor the JAX
    package."""
    io_sources = sorted(p.name for p in
                        (REPO / "rcppml_tpu_torch" / "io").glob("*.py"))
    assert io_sources == ["__init__.py", "loaders.py", "panels.py",
                          "rdata.py", "spz.py", "spz_meta.py", "upload.py"]
    code = ("import sys, rcppml_tpu_torch.io.spz, rcppml_tpu_torch.io.rdata, "
            "rcppml_tpu_torch.io.loaders, rcppml_tpu_torch.io.spz_meta, "
            "rcppml_tpu_torch.io.upload, rcppml_tpu_torch.io.panels, "
            "rcppml_tpu_torch.models.nmf_chunked, rcppml_tpu_torch.datasets; "
            "bad = [m for m in ('jax', 'rcppml_tpu') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

def _loader_pair(kind, tmp_path):
    A = _matrix("uint16", m=50, n=75, seed=8)
    if kind == "dense":
        D = A.toarray()
        return loaders.InMemoryLoader(D, chunk_cols=20), \
            ref_loaders.InMemoryLoader(D, chunk_cols=20)
    if kind == "sparse":
        return loaders.InMemoryLoader(A, chunk_cols=20), \
            ref_loaders.InMemoryLoader(A, chunk_cols=20)
    path = str(tmp_path / "l.spz")
    ref_spz.st_write(A, path, chunk_cols=20)
    return loaders.SpzLoader(path), ref_loaders.SpzLoader(path)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind", ["dense", "sparse", "spz"])
def test_loader_panels_equal_the_jax_loaders(kind, transpose, tmp_path):
    mine, ref = _loader_pair(kind, tmp_path)
    assert mine.shape == ref.shape
    assert mine.num_chunks(transpose) == ref.num_chunks(transpose)
    assert mine.supports_sparse == ref.supports_sparse
    assert mine.nnz() == ref.nnz()
    for c in range(mine.num_chunks(transpose)):
        a, b = mine.chunk(c, transpose), ref.chunk(c, transpose)
        assert (a.col_start, a.num_cols) == (b.col_start, b.num_cols)
        assert np.array_equal(np.asarray(a.data), np.asarray(b.data))
        if mine.supports_sparse:
            a, b = mine.chunk_coo(c, transpose), ref.chunk_coo(c, transpose)
            for field in ("rows", "counts", "vals"):
                assert np.array_equal(getattr(a, field), getattr(b, field))
            assert np.array_equal(a.cols_expanded(), b.cols_expanded())
    assert mine.trace_sq() == ref.trace_sq()


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("kind", ["dense", "sparse", "spz", "spz3"])
def test_chunk_traced_parts_add_up_to_trace_sq(kind, sparse, tmp_path):
    """Where a loader says it traces its panels, ``chunk_traced`` gives the
    panel ``chunk`` / ``chunk_coo`` gives, and its parts added in panel
    order are ``trace_sq()`` bit for bit; the in-memory scipy loader's COO
    panels cannot give the dense blocks' sum, and say so."""
    if kind == "spz3":
        path = str(tmp_path / "d.spz")
        rtt.st_write_dense(_matrix("uint16", m=50, n=75, seed=8).toarray(),
                           path, chunk_cols=20)
        ld = loaders.SpzLoader(path)
    else:
        ld = _loader_pair(kind, tmp_path)[0]
    # dense panels on every loader; COO panels off a v2 file's values
    assert ld.traces_panels(sparse) == (not sparse or kind == "spz")
    if not ld.traces_panels(sparse):
        return
    total = 0.0
    for c in range(ld.num_chunks()):
        ch, part = ld.chunk_traced(c, sparse)
        want = ld.chunk_coo(c) if sparse else ld.chunk(c)
        assert ch.col_start == want.col_start
        if sparse:
            for field in ("rows", "counts", "vals"):
                assert np.array_equal(getattr(ch, field), getattr(want, field))
        else:
            assert np.array_equal(ch.data, want.data)
        total += part
    assert total == ld.trace_sq()


@pytest.mark.parametrize("sparse", [False, True])
def test_prefetcher_keeps_panel_order(sparse, tmp_path):
    mine, ref = _loader_pair("spz", tmp_path)
    for transpose in (False, True):
        pf = loaders.Prefetcher(mine, transpose, sparse=sparse, depth=3)
        got = list(pf)
        pf.close()
        want = [ref.chunk_coo(c, transpose) if sparse else
                ref.chunk(c, transpose)
                for c in range(ref.num_chunks(transpose))]
        assert [ch.col_start for ch in got] == [ch.col_start for ch in want]
        for a, b in zip(got, want):
            if sparse:
                assert np.array_equal(a.vals, b.vals)
            else:
                assert np.array_equal(a.data, b.data)


def test_caching_loader(tmp_path):
    mine, _ = _loader_pair("spz", tmp_path)
    ld = loaders.CachingLoader(mine, max_items=2)
    c1 = ld.chunk(0)
    assert ld.chunk(0) is c1
    ld.chunk(1)
    ld.chunk(2)                           # evicts the oldest entry
    assert ld.chunk(0) is not c1
    assert np.array_equal(ld.chunk(0).data, c1.data)


@pytest.mark.parametrize("m,big", [(40_000, True), (300, False)])
def test_densify_widens_uint16_exactly(m, big):
    """Rows and values past 32767 survive the int16 wire view and the
    widening on the device; the scattered panel equals the host's."""
    rs = np.random.RandomState(9)
    nc = 6
    dense = np.zeros((m, nc), np.float32)
    rows = np.sort(rs.choice(m, 40, replace=False))
    if big:
        rows[-3:] = [m - 3, m - 2, m - 1]      # past 32767
    vals = rs.randint(1, 65536, size=40).astype(np.float32)
    vals[:2] = [65535, 32768]
    cols = np.repeat(np.arange(nc), [10, 0, 12, 8, 5, 5])
    order = np.lexsort((rows, cols))
    ch = loaders.SparseChunk(0, nc, rows[order].astype(np.int32),
                             np.bincount(cols, minlength=nc).astype(np.int32),
                             vals[order])
    dense[ch.rows, ch.cols_expanded()] = ch.vals
    wire = _compact_sparse(ch, m)
    assert wire.rows.dtype == np.uint16 and wire.vals.dtype == np.uint16
    dev = torch.device("cpu")
    got = coo_densify.coo_densify(
        *(upload(x, dev)
          for x in (wire.rows, wire.counts, wire.vals)), m)
    assert torch.equal(got, torch.from_numpy(dense))


# ---------------------------------------------------------------------------
# datasets, load_data, rdata
# ---------------------------------------------------------------------------

def test_datasets_missing_file_error(tmp_path, monkeypatch):
    errors = []
    for mod in (datasets, ref_datasets):
        monkeypatch.setattr(mod, "_DATA_DIR", str(tmp_path))
        mod._load_rda.cache_clear()
        with pytest.raises(FileNotFoundError) as exc:
            mod.aml()
        errors.append(str(exc.value))
        mod._load_rda.cache_clear()
    assert errors[0] == errors[1] and "aml.rda" in errors[0]


def _xdr_real_matrix(values, dim):
    """R's XDR serialization of a double vector with a ``dim`` attribute."""
    out = struct.pack(">i", 14 | 0x200) + struct.pack(">i", len(values))
    out += np.asarray(values, ">f8").tobytes()
    out += struct.pack(">i", 2 | 0x400)               # attribute pairlist
    out += struct.pack(">i", 1) + struct.pack(">i", 9) \
        + struct.pack(">i", 3) + b"dim"               # tag: symbol "dim"
    out += struct.pack(">i", 13) + struct.pack(">i", 2) \
        + np.asarray(dim, ">i4").tobytes()
    out += struct.pack(">i", 254)                     # end of attributes
    return out


def _xdr_header():
    return b"X\n" + struct.pack(">iii", 2, 0x040000, 0x020300)


@pytest.mark.parametrize("kind", ["rds", "rda"])
def test_rdata_reads_an_xdr_matrix_as_the_jax_reader(kind, tmp_path):
    values = np.arange(6, dtype=np.float64) * 1.5 - 2.0
    body = _xdr_real_matrix(values, (2, 3))
    if kind == "rds":
        path = tmp_path / "m.rds"
        path.write_bytes(gzip.compress(_xdr_header() + body))
        mine, ref = rdata.read_rds(str(path)), ref_rdata.read_rds(str(path))
    else:
        pairlist = (struct.pack(">i", 2 | 0x400) + struct.pack(">i", 1)
                    + struct.pack(">i", 9) + struct.pack(">i", 1) + b"m"
                    + body + struct.pack(">i", 254))
        path = tmp_path / "m.rda"
        path.write_bytes(gzip.compress(b"RDX2\n" + _xdr_header()
                                       + pairlist))
        mine, ref = rdata.read_rda(str(path)), ref_rdata.read_rda(str(path))
        assert list(mine) == list(ref) == ["m"]
        mine, ref = mine["m"], ref["m"]
    assert type(mine).__name__ == type(ref).__name__
    assert np.array_equal(np.asarray(mine), np.asarray(ref))
    assert np.asarray(mine).shape == (2, 3)
    assert np.array_equal(np.asarray(mine), values.reshape(3, 2).T)


@pytest.mark.parametrize("suffix", [".spz", ".npy", ".csv", ".mtx",
                                    ".npz", ".tsv"])
def test_load_data_as_the_jax_package(suffix, tmp_path):
    A = _matrix("uint16", m=12, n=9, seed=10)
    path = str(tmp_path / f"a{suffix}")
    if suffix == ".spz":
        ref_spz.st_write(A, path)
    elif suffix == ".npy":
        np.save(path, A.toarray())
    elif suffix == ".csv":
        np.savetxt(path, A.toarray(), delimiter=",")
    elif suffix == ".tsv":
        np.savetxt(path, A.toarray(), delimiter="\t")
    elif suffix == ".mtx":
        from scipy.io import mmwrite
        mmwrite(path, A)
    else:
        sp.save_npz(path, A)
    mine, ref = resources.load_data(path), ref_resources.load_data(path)
    dense = (lambda x: x.toarray() if sp.issparse(x) else np.asarray(x))
    assert sp.issparse(mine) == sp.issparse(ref)
    assert np.array_equal(dense(mine), dense(ref))
    with pytest.raises(FileNotFoundError):
        resources.load_data(str(tmp_path / "missing.spz"))
