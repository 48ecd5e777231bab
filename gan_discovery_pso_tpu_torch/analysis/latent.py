"""Latent-space analyses: projections, clustering, distances (counterpart of
`gan_discovery_pso_tpu/analysis/latent.py`: `pca_project` :22, `make_umap`
:30, `umap_project` :58, `get_clustering_algorithm` :67, `cluster_latents`
:92, `assign_to_clusters` :102, `mutual_distance` :110,
`pairwise_distances` :120, `voronoi_finite_polygons` :129), after
reference src/utils/util_latent_analysis.py.

PCA, k-means, the Gaussian mixture (`analysis/cluster.py`), UMAP
(`analysis/umap_impl.py`) and the distances run on `device`, the card
unless the caller names another; results come back as numpy arrays, as in
the JAX package. The Voronoi reconstruction stays on scipy, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_discovery_pso_tpu_torch.analysis.cluster import PCA, GaussianMixture, KMeans
from gan_discovery_pso_tpu_torch.analysis.umap_impl import UMAP, pairwise_dists
from gan_discovery_pso_tpu_torch.core.device import resolve_device


def pca_project(data, n_components: int = 2, return_model: bool = False, device=None):
    model = PCA(n_components=n_components, device=device)
    out = model.fit_transform(data)
    return (out, model) if return_model else out


def make_umap(n_components: int = 2, n_neighbors: int = 15, min_dist: float = 0.1,
              random_state: int = 42, init: str = "pca", device=None):
    """(a UMAP reducer with fit_transform/transform, "umap"); init "pca"
    (the deterministic default) or "spectral" (umap-learn's default, PCA on
    a degenerate graph)."""
    return UMAP(n_components=n_components, n_neighbors=n_neighbors, min_dist=min_dist,
                random_state=random_state, init=init, device=device), "umap"


def umap_project(data, n_components: int = 2, n_neighbors: int = 15, min_dist: float = 0.1,
                 random_state: int = 42, device=None):
    """(the UMAP embedding, "umap") (reference util_latent_analysis.py:45-64)."""
    reducer, tag = make_umap(n_components, n_neighbors, min_dist, random_state, device=device)
    return reducer.fit_transform(data), tag


def get_clustering_algorithm(name: str, n_clusters: int, seed: int = 42, data=None,
                             device=None):
    """The reference's names and hyper-parameters (util_pso_analysis.py:8-14;
    kmeans_fun/em_fun, util_latent_analysis.py:245-300): KMeans(k-means++,
    n_init=10); the Gaussian mixture's means_init from a 1-iteration
    k-means++ mixture when `data` is given (get_initial_means, :272-275),
    tol 1e-9, max_iter 2000."""
    if name == "kmeans":
        return KMeans(n_clusters, n_init=10, random_state=seed, device=device)
    if name in ("em", "expectation_maximization"):
        means_init = None
        if data is not None:
            means_init = GaussianMixture(
                n_clusters, init_params="k-means++", tol=1e-9, max_iter=1, random_state=seed,
                device=device).fit(np.asarray(data, np.float64)).means_
        return GaussianMixture(n_clusters, means_init=means_init, tol=1e-9, max_iter=2000,
                               random_state=seed, device=device)
    raise ValueError(name)


def cluster_latents(data, algorithm: str, n_clusters: int, seed: int = 42, device=None):
    """Fit and predict in float64 (the reference's .astype('double')):
    (labels, centers, model); a mixture's centers are its means."""
    data = np.asarray(data, np.float64)
    model = get_clustering_algorithm(algorithm, n_clusters, seed, data=data, device=device)
    labels = model.fit_predict(data)
    centers = model.cluster_centers_ if hasattr(model, "cluster_centers_") else model.means_
    return labels, centers, model


def assign_to_clusters(model, data) -> np.ndarray:
    """The cluster of each new point, predicted in float64 (OoD patient →
    discovered cluster, reference src/training/pso_inverter_analysis.py:180-210)."""
    return model.predict(np.asarray(data, np.float64))


def mutual_distance(a, b, device=None) -> np.ndarray:
    """Every ‖a_i − b_j‖, flattened (the reference's nested loop,
    util_latent_analysis.py:316-328), by `umap_impl.pairwise_dists` in the
    inputs' dtype, as the JAX package computes it, on `device`."""
    dev = resolve_device(device)
    a, b = np.asarray(a), np.asarray(b)
    dtype = torch.float64 if np.result_type(a, b) == np.float64 else torch.float32
    ta, tb = (torch.as_tensor(v, dtype=dtype, device=dev) for v in (a, b))
    return pairwise_dists(ta, tb).reshape(-1).cpu().numpy()


def pairwise_distances(a, device=None) -> np.ndarray:
    """The unordered within-set distances (reference Swarm.mse,
    src/pso/util_pso.py:76-86)."""
    a = np.asarray(a)
    d = mutual_distance(a, a, device=device).reshape(len(a), len(a))
    return d[np.triu_indices(len(a), k=1)]


def voronoi_finite_polygons(points: np.ndarray, radius: float | None = None):
    """2-D Voronoi regions with the infinite ones closed at `radius` (the
    reconstruction the reference plots, util_latent_analysis.py:66-166),
    on the host with scipy: (regions: list[list[int]], vertices)."""
    from scipy.spatial import Voronoi

    vor = Voronoi(np.asarray(points))
    if radius is None:
        radius = np.ptp(vor.points, axis=0).max() * 2

    center = vor.points.mean(axis=0)
    new_vertices = vor.vertices.tolist()
    all_ridges: dict[int, list] = {}
    for (p1, p2), (v1, v2) in zip(vor.ridge_points, vor.ridge_vertices):
        all_ridges.setdefault(p1, []).append((p2, v1, v2))
        all_ridges.setdefault(p2, []).append((p1, v1, v2))

    new_regions = []
    for p1, region_idx in enumerate(vor.point_region):
        vertices = vor.regions[region_idx]
        if all(v >= 0 for v in vertices):
            new_regions.append(vertices)
            continue
        # keep the finite vertices, extend each infinite ridge
        new_region = [v for v in vertices if v >= 0]
        for p2, v1, v2 in all_ridges.get(p1, []):
            if v2 < 0:
                v1, v2 = v2, v1
            if v1 >= 0:
                continue  # a finite ridge
            tangent = vor.points[p2] - vor.points[p1]
            tangent /= np.linalg.norm(tangent)
            normal = np.array([-tangent[1], tangent[0]])
            midpoint = vor.points[[p1, p2]].mean(axis=0)
            direction = np.sign(np.dot(midpoint - center, normal)) * normal
            far_point = vor.vertices[v2] + direction * radius
            new_region.append(len(new_vertices))
            new_vertices.append(far_point.tolist())
        # the region's vertices counter-clockwise
        vs = np.asarray([new_vertices[v] for v in new_region])
        angles = np.arctan2(vs[:, 1] - vs[:, 1].mean(), vs[:, 0] - vs[:, 0].mean())
        new_regions.append(list(np.asarray(new_region)[np.argsort(angles)]))
    return new_regions, np.asarray(new_vertices)
