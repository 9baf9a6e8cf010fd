"""Fit models of the port: initialization, full-batch Lloyd, the
step-paced runner, the accelerated fits, minibatch (in memory and streamed
from the host), trimmed, spherical and bisecting k-means, x-means and
g-means (automatic k), Gaussian mixtures (in memory and streamed), fuzzy
c-means, balanced (Sinkhorn) k-means, the pairwise families (k-medoids,
kernel k-means with Nyström features, spectral clustering), model
selection (k sweeps, the gap statistic, BIC / AIC) and the dendrogram
merge of fitted centroids."""

from kmeans_tpu_torch.models.accelerated import fit_lloyd_accelerated
from kmeans_tpu_torch.models.balanced import (BalancedKMeans, BalancedState,
                                              fit_balanced,
                                              resolve_capacities,
                                              sinkhorn_potentials)
from kmeans_tpu_torch.models.bisecting import BisectingKMeans, fit_bisecting
from kmeans_tpu_torch.models.fuzzy import (FuzzyCMeans, FuzzyState,
                                           fit_fuzzy, fuzzy_memberships)
from kmeans_tpu_torch.models.gmeans import (GMeans, anderson_darling_normal,
                                            fit_gmeans)
from kmeans_tpu_torch.models.gmm import (GaussianMixture, GMMParams,
                                         GMMState, fit_gmm, gmm_log_resp,
                                         gmm_predict, gmm_sample)
from kmeans_tpu_torch.models.gmm_stream import (fit_gmm_stream,
                                                gmm_assign_stream)
from kmeans_tpu_torch.models.hierarchy import (centroid_linkage, cut_linkage,
                                               merge_to_k)
from kmeans_tpu_torch.models.kernel import (KernelKMeans, KernelKMeansState,
                                            fit_kernel_kmeans, kernel_assign,
                                            nystrom_features)
from kmeans_tpu_torch.models.lloyd import (KMeans, KMeansState, fit_lloyd,
                                           fit_plan)
from kmeans_tpu_torch.models.medoids import (KMedoids, KMedoidsState,
                                             fit_kmedoids)
from kmeans_tpu_torch.models.minibatch import (MiniBatchKMeans, batch_update,
                                               fit_minibatch, nested_ladder)
from kmeans_tpu_torch.models.runner import IterInfo, LloydRunner
from kmeans_tpu_torch.models.selection import (gap_statistic, suggest_k,
                                               suggest_k_gap, sweep_k)
from kmeans_tpu_torch.models.spectral import (SpectralClustering,
                                              SpectralState, fit_spectral,
                                              spectral_embedding)
from kmeans_tpu_torch.models.spherical import (SphericalKMeans,
                                               fit_spherical, normalize_rows)
from kmeans_tpu_torch.models.streaming import (assign_stream,
                                               fit_minibatch_stream)
from kmeans_tpu_torch.models.trimmed import (TrimmedKMeans, TrimmedState,
                                             fit_trimmed)
from kmeans_tpu_torch.models.xmeans import XMeans, bic_score, fit_xmeans


def state_centers(state):
    """The (k, d) center array of any family's fit state, or ``None`` for
    center-free families: the reference's one copy of the field-name
    mapping (centroids / medoids / means)."""
    for attr in ("centroids", "medoids", "means"):
        arr = getattr(state, attr, None)
        if arr is not None:
            return arr
    return None


def state_counts(state):
    """The per-cluster size / mass array of any family's fit state, or
    ``None`` when it cannot be determined: the reference's one copy of the
    field-name mapping (counts / resp_counts, with a label histogram for a
    state that carries labels but no counts), beside :func:`state_centers`.
    The dendrogram merge reads it."""
    import numpy as np

    from kmeans_tpu_torch.models.hierarchy import _host

    for attr in ("counts", "resp_counts"):
        arr = getattr(state, attr, None)
        if arr is not None:
            return arr
    centers = state_centers(state)
    labels = getattr(state, "labels", None)
    if centers is None or labels is None:
        return None
    labels = np.asarray(_host(labels))
    return np.bincount(labels[labels >= 0], minlength=centers.shape[0])


def state_objective(state) -> float:
    """One lower-is-better scalar for any family's fit state, as in the
    reference: hard families report inertia, fuzzy / kernel their objective
    J, the GMM its negated log-likelihood.  The CLI's result line reads
    it."""
    if hasattr(state, "inertia"):
        return float(state.inertia)
    if hasattr(state, "objective"):
        return float(state.objective)
    return -float(state.log_likelihood)


__all__ = ["KMeans", "KMeansState", "fit_lloyd", "fit_plan",
           "fit_lloyd_accelerated", "fit_minibatch", "MiniBatchKMeans",
           "nested_ladder", "batch_update", "LloydRunner", "IterInfo",
           "fit_minibatch_stream", "assign_stream",
           "TrimmedKMeans", "TrimmedState", "fit_trimmed", "centroid_linkage",
           "cut_linkage", "merge_to_k", "state_centers", "state_counts",
           "state_objective", "SphericalKMeans", "fit_spherical",
           "normalize_rows", "BisectingKMeans", "fit_bisecting", "XMeans",
           "bic_score", "fit_xmeans", "GMeans", "anderson_darling_normal",
           "fit_gmeans", "sweep_k", "suggest_k", "gap_statistic",
           "suggest_k_gap", "GMMParams", "GMMState", "fit_gmm",
           "GaussianMixture", "gmm_predict", "gmm_log_resp", "gmm_sample",
           "fit_gmm_stream", "gmm_assign_stream", "FuzzyState", "fit_fuzzy",
           "FuzzyCMeans", "fuzzy_memberships", "BalancedState",
           "fit_balanced", "BalancedKMeans", "sinkhorn_potentials",
           "resolve_capacities", "KernelKMeans", "KernelKMeansState",
           "fit_kernel_kmeans", "kernel_assign", "nystrom_features",
           "KMedoids", "KMedoidsState", "fit_kmedoids", "SpectralClustering",
           "SpectralState", "fit_spectral", "spectral_embedding"]
