"""rcppml_tpu_torch — the PyTorch / CUDA port of ``rcppml_tpu``.

A second package beside the JAX one, which stays the reference.  So far it
carries:

  * the dense ALS-NMF fit with MSE loss, both solvers (Cholesky + clip and CD
    NNLS), the L1/L2/L21/angular/graph/target features, and the standard,
    projective and symmetric variants;
  * the IRLS fit for ``loss="kl"``, ``"gp"``, ``"nb"``, ``"gamma"``,
    ``"inverse_gaussian"``, ``"tweedie"``, ``"huber"``/``"mae"`` and
    ``robust=``, with the dispersion updates (per row, per column, global,
    none), zero inflation (``zi="row"/"col"``) and sparse-input semantics;
  * on dense MSE fits, the opt-in whole-fit Newton-Schulz ALS
    (``fused_vmem=True``), bfloat16 data (``bf16_data=True``), multi-restart
    (``seed=[...]``), per-iteration callbacks (``on_iteration=``) and the
    profiled fit (``profile=True``);
  * speckled cross-validation (``test_fraction=``, ``cv_seed=``,
    ``cv_patience=``, row and column subsampling), masked fits (``mask=`` a
    boolean matrix, ``"zeros"`` or ``"NA"``; ``sparse=True``; NaN entries),
    both with every loss above, rank sweeps (``k=[...]``) and the rank search
    (``k="auto"``);
  * SVD-seeded NMF (``seed="lanczos"`` / ``"irlba"``) and the profiled IRLS
    fit (``profile=True`` with an IRLS loss);
  * truncated SVD and PCA (``svd``, ``pca``: Lanczos, IRLBA, randomized,
    Krylov-seeded projected refinement and deflation, with constraints,
    robust fits, masks and cross-validated rank selection);
  * the projection API (``nnls``, ``predict``, ``evaluate``, ``mse``) and
    the generics ``reconstruct``, ``sparsity`` and ``variance_explained``;
  * rank-2 divisive clustering (``bipartition``, ``dclust``), consensus NMF
    (``consensus_nmf``) and factor matching (``bipartite_match`` /
    ``bipartiteMatch``, ``align``);
  * preemption-safe checkpointed fits (``nmf(..., checkpoint_path=)``,
    ``utils/checkpoint.py``, files shared with the JAX package);
  * the analysis utilities: distribution diagnostics, embedding metrics and
    classifiers, guided refinement, the training log, plots, the R samplers
    (``r_*``), simulators, leveled logging and device introspection
    (``gpu_available`` / ``gpu_info``);
  * out-of-core streaming: the ``.spz`` codec and the whole ``st_*``
    surface (``io/spz.py``, the codec compiled from ``native/
    streampress.cpp`` with ``g++`` at first use), the panel loaders
    (``io/loaders.py``), ``nmf("x.spz", k)`` / ``streaming=True`` and the
    automatic switch to streaming for a matrix the card cannot hold
    (``models/nmf_chunked.py``), ``streaming_svd`` and ``svd("x.spz")``,
    ``nnls_streaming``, ``load_data`` and ``datasets``;
  * the FactorNet graph engine (``models/graph.py``): the node builders
    (``factor_input``, ``factor_shared``, ``factor_concat``,
    ``factor_add``, ``factor_condition``, ``nmf_layer``, ``svd_layer``,
    ``W`` / ``H``), ``factor_config`` / ``GlobalConfig``, ``factor_net``,
    ``fit`` (the multi-layer outer ALS on the device) and
    ``cross_validate_graph``; ``nmf([A1, A2], k)`` / ``nmf({...}, k)`` fits
    a shared-H net over the modalities.

Ten kernels written for Hopper run on a CUDA tensor, each with a plain
PyTorch twin that runs on a CPU tensor: the shared-Gram CD NNLS solve
(``csrc/cd_nnls_shared.cu``), the CD NNLS solve with one Gram per column that
every IRLS inner iteration and every CD-mode masked solve calls
(``csrc/cd_nnls_batched.cu``), the fused IRLS weight + weighted Gram + RHS
(``csrc/wgram_rhs.cu``), used when ``RCPPML_FUSED_WGRAM`` is set in the
environment, the whole-fit Newton-Schulz ALS (``csrc/fused_als.cu``), the two
products that read A once, B = F A and B = H A^T (``csrc/rhs_tall.cu``), which
the whole-fit kernel contains and the default loop calls when A is bfloat16,
the per-column weighted Gram + RHS from given weights
(``csrc/weighted_gram.cu``), which the masked and IRLS solves call when k^2 m
is too large for the Khatri-Rao product, the shared-Gram Cholesky solve +
clip (``csrc/cholesky_clip.cu``), the solve of every default MSE fit, and
the scatter that densifies a stream's compact COO panel on the card
(``csrc/coo_densify.cu``, kernel 9), and the copy that builds a stream's
transposed panel from the forward panels its dense cache holds
(``csrc/transpose_panels.cu``, kernel 10).

Entry points run on the CUDA card unless the caller asks for ``device="cpu"``
or passes a CPU tensor.  A device mesh over ``torch.distributed``
(``parallel/``: ``default_mesh``, ``multihost.initialize``,
``multihost.shard_host_data``) runs ``nmf(..., mesh=)`` with one process a
rank: MSE, IRLS, cross-validated and masked fits, checkpointed fits,
streaming (``nmf_chunked(loader, cfg, mesh=)``, ``nmf("x.spz", k, mesh=)``)
and the graph engine (``fit(net, mesh=)``).

It imports ``torch`` and never ``jax``; kernels are built with ``nvcc`` at
first use, never at import.
"""

from . import datasets
from .api import build_config, nmf
from .config import (ZI, Dispersion, FactorConfig, Loss, NMFConfig, Norm,
                     Solver, SVDConfig)
from .device import kernels_available, set_fp32_precision
from .models.clustering import (align_factors, bipartite_match,
                                bipartition, consensus_nmf, dclust)
from .io.spz import (st_add_transpose, st_chunk_ranges, st_convert,
                     st_filter_cols, st_filter_rows, st_free_device, st_info,
                     st_map_chunks, st_obs_indices, st_read, st_read_auto,
                     st_read_dense, st_read_device, st_read_dimnames,
                     st_read_obs, st_read_transpose, st_read_var, st_slice,
                     st_slice_cols, st_slice_rows, st_write, st_write_dense,
                     st_write_list, st_write_with_metadata)
from .models.graph import (GlobalConfig, H, W, cross_validate_graph,
                           factor_add, factor_concat, factor_condition,
                           factor_config, factor_input, factor_net,
                           factor_shared, fit, nmf_layer, svd_layer)
from .models.project import evaluate, mse, nnls, nnls_streaming, predict
from .models.svd import pca, streaming_svd, svd
from .parallel.mesh import default_mesh
from .result import NMFResult, SVDResult
from .rng import r_binom, r_matrix, r_sample, r_sparsematrix, r_unif
from .utils.diagnostics import (auto_nmf_distribution, diagnose_dispersion,
                                diagnose_zero_inflation,
                                score_test_distribution)
from .utils.guided import compute_target, refine
from .utils.logging import LogLevel, get_verbosity, set_verbosity
from .utils.metrics import (assess, classify_embedding, classify_logistic,
                            classify_rf, cosine)
from .utils.plots import (biplot, compare_nmf, plot_consensus, plot_cv,
                          plot_dclust, plot_nmf, plot_summary)
from .utils.resources import (accelerator_available, accelerator_info,
                              gpu_available, gpu_info, load_data,
                              select_resources)
from .utils.simulate import simulate_nmf, simulate_swimmer
from .utils.training_log import export_log, training_logger

# the R names of the reference's NAMESPACE
bipartiteMatch = bipartite_match
align = align_factors
simulateNMF = simulate_nmf
simulateSwimmer = simulate_swimmer
# the reference's GPU-read names (R/sp_gpu.R)
st_read_gpu = st_read_device
st_free_gpu = st_free_device

# the whole streampress st_* surface (R/streampress.R)
_ST_NAMES = (
    "st_write", "st_read", "st_read_transpose", "st_info", "st_write_dense",
    "st_read_dense", "st_read_auto", "st_add_transpose", "st_convert",
    "st_read_obs", "st_read_var", "st_read_dimnames",
    "st_write_with_metadata", "st_chunk_ranges", "st_slice_cols",
    "st_slice_rows", "st_slice", "st_map_chunks", "st_obs_indices",
    "st_filter_cols", "st_filter_rows", "st_write_list", "st_read_device")

# the factor-graph engine (R/factor_net.R surface)
_GRAPH_NAMES = (
    "factor_input", "factor_shared", "factor_concat", "factor_add",
    "factor_condition", "factor_config", "nmf_layer", "svd_layer",
    "factor_net", "fit", "cross_validate_graph", "W", "H", "GlobalConfig")


# R generics: free functions delegating to the result object
def reconstruct(obj, *args, **kwargs):
    return obj.reconstruct(*args, **kwargs)


def sparsity(obj, *args, **kwargs):
    return obj.sparsity(*args, **kwargs)


def variance_explained(obj, *args, **kwargs):
    return obj.variance_explained(*args, **kwargs)


__all__ = ["nmf", "build_config", "svd", "pca", "nnls", "predict",
           "evaluate", "mse", "reconstruct", "sparsity", "variance_explained",
           "NMFConfig", "FactorConfig", "SVDConfig", "NMFResult", "SVDResult",
           "Loss", "Norm", "Solver", "Dispersion", "ZI", "kernels_available",
           "set_fp32_precision",
           "bipartition", "dclust", "consensus_nmf", "bipartite_match",
           "bipartiteMatch", "align",
           "auto_nmf_distribution", "score_test_distribution",
           "diagnose_zero_inflation", "diagnose_dispersion",
           "assess", "cosine", "classify_embedding", "classify_logistic",
           "classify_rf", "compute_target", "refine",
           "simulateNMF", "simulateSwimmer", "simulate_nmf",
           "simulate_swimmer", "training_logger", "export_log",
           "compare_nmf", "biplot", "plot_nmf", "plot_cv", "plot_dclust",
           "plot_consensus", "plot_summary",
           "r_matrix", "r_sparsematrix", "r_sample", "r_unif", "r_binom",
           "accelerator_available", "accelerator_info", "gpu_available",
           "gpu_info", "set_verbosity", "get_verbosity", "LogLevel",
           "streaming_svd", "nnls_streaming", "load_data",
           "select_resources", "datasets", "st_read_gpu", "st_free_gpu",
           "st_free_device", "default_mesh", *_ST_NAMES, *_GRAPH_NAMES]
