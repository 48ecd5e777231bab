"""The latent analyses on the stage's device (`latent.py`: PCA, UMAP,
k-means, the Gaussian mixture, distances; `cluster.py`, `umap_impl.py`)
and the host-side report writers (`reporting.py`; matplotlib and PIL are
imported inside the writers)."""

from gan_discovery_pso_tpu_torch.analysis.latent import (
    assign_to_clusters,
    cluster_latents,
    get_clustering_algorithm,
    mutual_distance,
    pairwise_distances,
    pca_project,
    umap_project,
    voronoi_finite_polygons,
)

__all__ = ["assign_to_clusters", "cluster_latents", "get_clustering_algorithm",
           "mutual_distance", "pairwise_distances", "pca_project", "umap_project",
           "voronoi_finite_polygons"]
