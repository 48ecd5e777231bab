"""K-nearest-neighbour posteriors on the device (counterpart of
`gan_discovery_pso_tpu/ops/knn.py`: `pairwise_sq_dists` :24,
`knn_predict_proba` :33, `knn_battery_posterior` :51).

The reference's "Inception" classifier battery is one sklearn
`KNeighborsClassifier(n_neighbors=5)` per IiD class on CAE embeddings
(reference src/training/classifiers.py:166-184), queried per image and per
class. Here every classifier shares one distance matrix: an expanded-form
distance product, the k nearest training rows, and a one-hot label average
give the posterior of all images for all classes at once.

Which neighbours are chosen:
- ties in distance go to the lower training index, as the JAX package's
  `lax.top_k` and sklearn's sorted search give them: the k nearest come
  from a stable sort of each row (`torch.topk` documents no tie order);
- the distance product runs in full fp32 (`highest_precision`, no TF32
  under `--fast-math` either, as the JAX package pins it at HIGHEST), since
  TF32 would move neighbours;
- the expanded form q² + p² − 2q·p still rounds differently in each BLAS,
  so a near-tie (k-th and (k+1)-th distances within rounding) may pick
  another neighbour on the card than on the CPU or in the JAX package.
"""

from __future__ import annotations

import torch

from gan_discovery_pso_tpu_torch.ops.precision import highest_precision


def pairwise_sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances [Nq, Np] by the expanded form, its
    product in full fp32."""
    q2 = torch.sum(queries * queries, dim=1, keepdim=True)
    p2 = torch.sum(points * points, dim=1)[None, :]
    with highest_precision():
        cross = torch.matmul(queries, points.T)
    return q2 + p2 - 2.0 * cross


def nearest(queries: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [Nq, k] of each query's k nearest points, nearest first, a
    tie going to the lower index."""
    d = pairwise_sq_dists(queries, points)
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def knn_predict_proba(queries: torch.Tensor, train_x: torch.Tensor, train_y: torch.Tensor,
                      k: int = 3) -> torch.Tensor:
    """P(y = 1 | query) of a binary KNN: the share of the k nearest training
    rows whose label is 1. Returns [Nq]."""
    return train_y.float()[nearest(queries, train_x, k)].mean(dim=1)


def knn_battery_posterior(queries: torch.Tensor, train_x: torch.Tensor,
                          train_labels: torch.Tensor, classes: torch.Tensor, k: int = 5,
                          chunk_size: int | None = None) -> torch.Tensor:
    """The posterior matrix [Nq, C]: column c is the one-vs-all KNN
    probability of class `classes[c]`. `chunk_size` bounds the [Nq, Ntrain]
    distance matrix to that many queries at a time; each row's result does
    not depend on it."""
    if chunk_size is not None and queries.shape[0] > chunk_size:
        return torch.cat([knn_battery_posterior(queries[i:i + chunk_size], train_x,
                                                train_labels, classes, k)
                          for i in range(0, queries.shape[0], chunk_size)])
    neigh = train_labels[nearest(queries, train_x, k)]  # [Nq, k]
    return (neigh[:, :, None] == classes[None, None, :]).float().mean(dim=1)
