"""The matrix as a ``.spz`` file, written once in set-up with the program's
``st_write`` (``traffic["chunk_cols"]`` columns a panel, with the transpose
stream the W updates read) into the run's temporary directory.

The CSC matrix is built on the device a block of columns at a time (a copy
of ``chip_smoke.py::csc_of_columns``): ``nonzero()`` of a row-major block of
A^T lists the entries in CSC order.
"""

import os

import numpy as np
import torch

CSC_BLOCK = 4096


def csc_of(A: torch.Tensor):
    import scipy.sparse as sp
    m, n = A.shape
    counts, rows, vals = [], [], []
    for j0 in range(0, n, CSC_BLOCK):
        At = A[:, j0:j0 + CSC_BLOCK].T.contiguous()
        nz = At.nonzero()
        counts.append(torch.bincount(nz[:, 0], minlength=At.shape[0]))
        rows.append(nz[:, 1].to(torch.int32).cpu())
        vals.append(At[nz[:, 0], nz[:, 1]].cpu())
        del At, nz
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.cat(counts).cpu().numpy(), out=indptr[1:])
    return sp.csc_matrix((torch.cat(vals).numpy(), torch.cat(rows).numpy(),
                          indptr), shape=(m, n))


def prepare(A, traffic: dict, workdir: str):
    """Returns (the path handed to ``nmf``, False: the benchmark drops A
    and makes it again from the seed for the reference)."""
    import rcppml_tpu_torch as rtt
    path = os.path.join(workdir, "matrix.spz")
    rtt.st_write(csc_of(A), path, chunk_cols=int(traffic["chunk_cols"]))
    return path, False
