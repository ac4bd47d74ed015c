"""Built-in parity datasets, loaded from the reference package's .rda files
(SURVEY.md §2.12): aml (dense ATAC), movielens (sparse ratings), golub,
hawaiibirds, olivetti (faces), digits, pbmc3k (scRNA-seq shipped as raw SPZ
bytes -> decoded via the streampress reader).

The port's copy of ``rcppml_tpu/datasets.py``: the files are read from
``$RCPPML_TPU_DATA``, else from the JAX package's default directory;
nothing is downloaded.  A missing file raises ``FileNotFoundError`` as in
the JAX package.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

_DATA_DIR = os.environ.get("RCPPML_TPU_DATA",
                           "/root/reference/data")


@functools.lru_cache(maxsize=None)
def _load_rda(name: str):
    from .io.rdata import read_rda
    path = os.path.join(_DATA_DIR, f"{name}.rda")
    return read_rda(path)[name]


def aml() -> np.ndarray:
    """824 x 135 dense ATAC-seq signal matrix.

    R attributes survive as ``.attrs``: ``attrs["metadata_h"]`` holds the
    per-sample category/samples columns (R/data.R:71-100)."""
    from .io.rdata import RMatrix
    raw = _load_rda("aml")
    arr = np.asarray(raw, dtype=np.float32).view(RMatrix)
    arr.attrs = getattr(raw, "attrs", {})
    return arr


def movielens():
    """3,867 x 610 sparse movie-ratings matrix (csc).

    ``.attrs``: per-movie ``genres``, dimnames."""
    return _load_rda("movielens")


def golub():
    """``.attrs``: cancer_type / cell_type labels, dimnames.  38 x 5,000 leukemia expression matrix (csc)."""
    return _load_rda("golub")


def hawaiibirds():
    """183 x 1,183 bird-count matrix (csc).

    R attributes survive as ``.attrs``: ``attrs["metadata_h"]`` (per-site
    grid/island/lat/lng) and ``attrs["metadata_w"]`` (per-species info) —
    the label sources the guided-NMF workflow uses (R/data.R:121-128)."""
    return _load_rda("hawaiibirds")


def olivetti():
    """400 x 4,096 face-image matrix (csc, effectively dense).

    ``.attrs``: per-image ``subject`` ids, ``image_shape``."""
    return _load_rda("olivetti")


def digits():
    """``.attrs``: ``target`` digit labels, ``image_shape``.  1,797 x 64 handwritten-digit matrix (csc)."""
    return _load_rda("digits")


def pbmc3k():
    """13,714 x 2,638 scRNA-seq counts, decoded from embedded SPZ bytes
    (tests/testthat/helper-test-utils.R:19-25)."""
    raw = _load_rda("pbmc3k")
    from .io.spz import decompress_spz_bytes
    return decompress_spz_bytes(np.asarray(raw, dtype=np.uint8).tobytes())


def pbmc3k_cell_types() -> np.ndarray:
    """Per-cell type annotations from the embedded obs/var table (written by
    the reference encoder; decoded via our metadata reader)."""
    raw = np.asarray(_load_rda("pbmc3k"), dtype=np.uint8).tobytes()
    from .io.spz_meta import read_obs_var_table, v2_table_offsets
    for off in v2_table_offsets(raw)[:2]:
        if off:
            tbl = read_obs_var_table(raw, off)
            if "cell_type" in tbl:
                return np.asarray([str(v) for v in tbl["cell_type"]])
    raise ValueError("no cell_type table found")
