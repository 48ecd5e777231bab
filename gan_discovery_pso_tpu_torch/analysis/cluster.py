"""PCA, k-means and the Gaussian mixture in torch, on the device, in
float64: the subset of scikit-learn that the latent analyses call
(`gan_discovery_pso_tpu/analysis/latent.py:22-107`), since the card's host
has no sklearn. Each follows scikit-learn 1.9.0's own rules, so the labels
and projections agree with it:

- `PCA` (sklearn/decomposition/_pca.py `_fit`, `_fit_full`): the "auto"
  solver picks "covariance_eigh" (the eigenvectors of XᵀX) for n ≥ 10·d
  with d ≤ 1000 and otherwise the full SVD of the centred data, and
  `svd_flip(u_based_decision=False)` makes the largest entry of each
  component positive, which is what makes cuSOLVER's and LAPACK's vectors
  agree. Where sklearn would pick its randomized solver (more than 500
  rows or columns and n_components < 0.8·min(n, d)) this takes the full
  SVD: the exact result that the randomized one approximates.
- `KMeans` (sklearn/cluster/_kmeans.py): the data centred; per init,
  k-means++ with 2 + int(log k) local trials, its first centre and trial
  draws from one `numpy.random.RandomState(seed)` in sklearn's order;
  Lloyd iterations (‖c‖² − 2x·c, the first minimum winning; centres as
  sequential sums scaled by 1/count; an empty cluster takes the farthest
  point) until the labels repeat (strict convergence) or the squared
  centre shift falls to tol × the mean per-feature variance, then one more
  E-step; the init of least inertia wins unless it is the same clustering.
- `GaussianMixture` (sklearn/mixture/_base.py, _gaussian_mixture.py), full
  covariances: responsibilities from a 1-init KMeans ("kmeans") or the
  k-means++ indices ("k-means++"), weights and covariances from them,
  `means_init` replacing only the means; EM until the change of the mean
  log-likelihood is below `tol`; labels the argmax of the weighted
  log-probability after a last E-step.

The draws are numpy's, on the host; the arithmetic runs on `device` (the
card unless the caller names another) and the fitted attributes are numpy
arrays. A pickle keeps no device: a loaded model computes on the card
unless `.to(device)` names another, so one fitted on the card predicts on
a host without CUDA after `.to("cpu")`.
`compat.weights.cluster_model_from_sklearn` carries a fitted sklearn model
across.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_discovery_pso_tpu_torch.core.device import resolve_device

F64 = torch.float64
KMEANS_MAX_ITER, KMEANS_TOL = 300, 1e-4  # sklearn's KMeans defaults
REG_COVAR = 1e-6  # sklearn's GaussianMixture default


def _as64(x, device) -> torch.Tensor:
    """x (an array or a tensor) as float64 on `device`."""
    return torch.as_tensor(x, dtype=F64, device=device)


def _rng(random_state) -> np.random.RandomState:
    """sklearn's check_random_state."""
    if isinstance(random_state, np.random.RandomState):
        return random_state
    return np.random.RandomState(random_state)


def _svd_flip_v(v: torch.Tensor) -> torch.Tensor:
    """Signs [k] that make each row's largest |entry| of v positive."""
    idx = torch.argmax(v.abs(), dim=1)
    return torch.sign(v.gather(1, idx[:, None])[:, 0])


class _OnDevice:
    """Where a model computes: `device`, resolved by the port's policy,
    and not pickled (see the module's docstring)."""

    device: str | None

    def to(self, device):
        self.device = str(resolve_device(device))
        return self

    @property
    def _device(self) -> torch.device:
        return resolve_device(self.device)

    def __getstate__(self):
        return {**self.__dict__, "device": None}


class PCA(_OnDevice):
    """sklearn's `PCA(n_components)` with svd_solver="auto", whiten=False."""

    def __init__(self, n_components: int = 2, device=None):
        self.n_components = n_components
        self.to(device)

    def _fit(self, x) -> torch.Tensor:
        """Fit; return the training data's projection [n, k]."""
        X = _as64(x, self._device)
        n, d = X.shape
        k = int(self.n_components)
        if not 0 <= k <= min(n, d):
            raise ValueError(f"n_components={k} must be between 0 and min(n_samples, "
                             f"n_features)={min(n, d)}")
        mean = X.mean(dim=0)
        self.solver_ = "covariance_eigh" if d <= 1000 and n >= 10 * d else "full"
        if self.solver_ == "full":
            U, S, Vt = torch.linalg.svd(X - mean, full_matrices=False)
            var = S ** 2 / (n - 1)
            signs = _svd_flip_v(Vt)
            U, Vt = U * signs[None, :], Vt * signs[:, None]
        else:
            C = X.T @ X
            C = C - n * mean[:, None] * mean[None, :]
            C = C / (n - 1)
            evals, evecs = torch.linalg.eigh(C)
            var = torch.flip(evals, dims=(0,)).clamp_min(0.0)
            Vt = torch.flip(evecs, dims=(1,)).T
            Vt = Vt * _svd_flip_v(Vt)[:, None]
            U = None
        self.mean_ = mean.cpu().numpy()
        self.components_ = Vt[:k].cpu().numpy()
        self.explained_variance_ = var[:k].cpu().numpy()
        self.explained_variance_ratio_ = (var[:k] / var.sum()).cpu().numpy()
        self.singular_values_ = torch.sqrt(var[:k] * (n - 1)).cpu().numpy()
        self.n_components_ = k
        if U is not None:  # sklearn's fit_transform: U·S, or the centred data on Vᵀ
            return U[:, :k] * S[:k][None, :]
        return (X - mean) @ Vt[:k].T

    def fit(self, x):
        self._fit(x)
        return self

    def fit_transform(self, x) -> np.ndarray:
        return self._fit(x).cpu().numpy()

    def transform(self, x) -> np.ndarray:
        X = _as64(x, self._device)
        mean = torch.as_tensor(self.mean_, device=self._device)
        comp = torch.as_tensor(self.components_, device=self._device)
        return ((X - mean) @ comp.T).cpu().numpy()


def _sq_dists(a: torch.Tensor, b: torch.Tensor, b_sq: torch.Tensor) -> torch.Tensor:
    """sklearn's `_euclidean_distances(a, b, Y_norm_squared=b_sq,
    squared=True)` in float64: −2·a·bᵀ + ‖a‖² + ‖b‖², floored at 0."""
    d = -2 * (a @ b.T)
    d = d + (a * a).sum(dim=1)[:, None]
    d = d + b_sq[None, :]
    return d.clamp_min(0.0)


def kmeans_plusplus(X: torch.Tensor, n_clusters: int, x_sq: torch.Tensor,
                    rs: np.random.RandomState) -> torch.Tensor:
    """sklearn's `_kmeans_plusplus` with unit sample weights: the indices
    [k] of the seeds, the draws from `rs` in sklearn's order."""
    n = X.shape[0]
    trials = 2 + int(np.log(n_clusters))
    first = rs.choice(n, p=np.ones(n) / n)
    indices = [torch.tensor(int(first), device=X.device)]
    closest = _sq_dists(X[first][None], X, x_sq)[0]
    pot = closest.sum()
    for _ in range(1, n_clusters):
        rand = torch.as_tensor(rs.uniform(size=trials), device=X.device) * pot
        cand = torch.searchsorted(torch.cumsum(closest, 0), rand).clamp_max(n - 1)
        dist = torch.minimum(closest[None], _sq_dists(X[cand], X, x_sq))
        pots = dist.sum(dim=1)
        best = torch.argmin(pots)
        pot, closest = pots[best], dist[best]
        indices.append(cand[best])
    return torch.stack(indices)


def _assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The nearest centre of each row by ‖c‖² − 2x·c, the first minimum
    winning (sklearn's `_update_chunk_dense`)."""
    d = torch.addmm((centers * centers).sum(dim=1)[None, :], X, centers.T, beta=1, alpha=-2)
    return torch.argmin(d, dim=1)


def _lloyd(X: torch.Tensor, centers: torch.Tensor, max_iter: int, tol: float):
    """sklearn's `_kmeans_single_lloyd`: (labels, inertia, centers, n_iter)."""
    n, d = X.shape
    k = centers.shape[0]
    labels_old = torch.full((n,), -1, dtype=torch.int64, device=X.device)
    strict = False
    for i in range(max_iter):
        labels = _assign(X, centers)
        sums = torch.zeros(k, d, dtype=F64, device=X.device).index_put_(
            (labels,), X, accumulate=True)
        counts = torch.zeros(k, dtype=F64, device=X.device).index_put_(
            (labels,), torch.ones(n, dtype=F64, device=X.device), accumulate=True)
        empty = torch.nonzero(counts == 0)[:, 0]
        if len(empty):  # sklearn's _relocate_empty_clusters_dense
            far = ((X - centers[labels]) ** 2).sum(dim=1)
            if float(far.max()) > 0:
                order = torch.argsort(far, descending=True, stable=True)[:len(empty)]
                for new, idx in zip(empty.tolist(), order.tolist()):
                    old = int(labels[idx])
                    sums[old] -= X[idx]
                    sums[new] = X[idx]
                    counts[new] = 1.0
                    counts[old] -= 1.0
        filled = counts > 0
        new_centers = torch.where(filled[:, None], sums * (1.0 / counts)[:, None],
                                  sums[torch.argmax(counts)][None, :])
        shift = torch.sqrt(((new_centers - centers) ** 2).sum(dim=1))
        centers = new_centers
        if torch.equal(labels, labels_old):
            strict = True
            break
        if float((shift ** 2).sum()) <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia, centers, i + 1


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """sklearn's `_is_same_clustering`: a and b equal up to a permutation."""
    mapping = np.full(k, -1)
    for x, y in zip(a, b):
        if mapping[x] == -1:
            mapping[x] = y
        elif mapping[x] != y:
            return False
    return True


class KMeans(_OnDevice):
    """sklearn's `KMeans(n_clusters, init="k-means++", n_init,
    random_state)` with the Lloyd algorithm, max_iter 300 and tol 1e-4."""

    def __init__(self, n_clusters: int = 8, n_init: int = 10, random_state=None, device=None):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.random_state = random_state
        self.to(device)

    def fit(self, x):
        X = _as64(x, self._device)
        if X.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={X.shape[0]} should be >= "
                             f"n_clusters={self.n_clusters}.")
        tol = float(X.var(dim=0, unbiased=False).mean()) * KMEANS_TOL
        rs = _rng(self.random_state)
        mean = X.mean(dim=0)
        X = X - mean
        x_sq = (X * X).sum(dim=1)
        best = None
        for _ in range(self.n_init):
            init = X[kmeans_plusplus(X, self.n_clusters, x_sq, rs)]
            labels, inertia, centers, n_iter = _lloyd(X, init, KMEANS_MAX_ITER, tol)
            labels = labels.cpu().numpy()
            if best is None or (inertia < best[1] and not _same_clustering(
                    labels, best[0], self.n_clusters)):
                best = (labels, inertia, centers, n_iter)
        self.labels_ = best[0].astype(np.int32)
        self.inertia_ = best[1]
        self.cluster_centers_ = (best[2] + mean).cpu().numpy()
        self.n_iter_ = best[3]
        return self

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_

    def predict(self, x) -> np.ndarray:
        X = _as64(x, self._device)
        centers = torch.as_tensor(self.cluster_centers_, device=self._device)
        return _assign(X, centers).cpu().numpy().astype(np.int32)


def _gaussian_parameters(X: torch.Tensor, resp: torch.Tensor):
    """sklearn's `_estimate_gaussian_parameters`, full covariances:
    (nk, means, covariances)."""
    nk = resp.sum(dim=0) + 10 * torch.finfo(F64).eps
    means = (resp.T @ X) / nk[:, None]
    diff = X[None, :, :] - means[:, None, :]  # [k, n, d]
    cov = ((resp.T[:, None, :] * diff.transpose(1, 2)) @ diff) / nk[:, None, None]
    cov = cov + REG_COVAR * torch.eye(X.shape[1], dtype=F64, device=X.device)
    return nk, means, cov


def _precision_cholesky(cov: torch.Tensor) -> torch.Tensor:
    """L⁻ᵀ of each covariance's Cholesky factor L (sklearn's
    `_compute_precision_cholesky`)."""
    chol, info = torch.linalg.cholesky_ex(cov)
    if bool((info > 0).any()):
        raise ValueError("Fitting the mixture model failed because some components have "
                         "ill-defined empirical covariance (for instance caused by singleton "
                         "or collapsed samples). Try to decrease the number of components "
                         "or scale the input data.")
    eye = torch.eye(cov.shape[-1], dtype=F64, device=cov.device).expand_as(cov)
    return torch.linalg.solve_triangular(chol, eye, upper=False).transpose(1, 2)


def _log_gaussian(X: torch.Tensor, means: torch.Tensor, prec_chol: torch.Tensor):
    """sklearn's `_estimate_log_gaussian_prob`, full covariances: [n, k]."""
    d = X.shape[1]
    log_det = torch.log(torch.diagonal(prec_chol, dim1=1, dim2=2)).sum(dim=1)
    y = X[None] @ prec_chol - (means[:, None, :] @ prec_chol)  # [k, n, d]
    log_prob = (y * y).sum(dim=2).T
    return -0.5 * (d * np.log(2 * np.pi) + log_prob) + log_det[None, :]


class GaussianMixture(_OnDevice):
    """sklearn's `GaussianMixture(n_components, covariance_type="full",
    init_params, means_init, tol, max_iter, random_state)`, n_init=1,
    reg_covar 1e-6."""

    def __init__(self, n_components: int = 1, tol: float = 1e-3, max_iter: int = 100,
                 init_params: str = "kmeans", means_init=None, random_state=None,
                 device=None):
        if init_params not in ("kmeans", "k-means++"):
            raise ValueError(f"init_params {init_params!r}: 'kmeans' or 'k-means++'")
        self.n_components = n_components
        self.tol = tol
        self.max_iter = max_iter
        self.init_params = init_params
        self.means_init = means_init
        self.random_state = random_state
        self.to(device)

    def _weighted_log_prob(self, X: torch.Tensor, params) -> torch.Tensor:
        weights, means, _cov, prec_chol = params
        return _log_gaussian(X, means, prec_chol) + torch.log(weights)[None, :]

    def _initial_resp(self, X: torch.Tensor, rs: np.random.RandomState) -> torch.Tensor:
        n, k = X.shape[0], self.n_components
        if self.init_params == "kmeans":
            labels = KMeans(k, n_init=1, random_state=rs, device=self._device).fit(X).labels_
            rows, cols = torch.arange(n), torch.as_tensor(labels, dtype=torch.int64)
        else:
            cols = torch.arange(k)
            rows = kmeans_plusplus(X, k, (X * X).sum(dim=1), rs).cpu()
        resp = torch.zeros(n, k, dtype=F64)
        resp[rows, cols] = 1.0
        return resp.to(X.device)

    def fit_predict(self, x) -> np.ndarray:
        X = _as64(x, self._device)
        n = X.shape[0]
        if n < self.n_components:
            raise ValueError(f"Expected n_samples >= n_components but got n_components = "
                             f"{self.n_components}, n_samples = {n}")
        rs = _rng(self.random_state)
        nk, means, cov = _gaussian_parameters(X, self._initial_resp(X, rs))
        if self.means_init is not None:
            means = _as64(self.means_init, self._device)
        params = (nk / n, means, cov, _precision_cholesky(cov))
        lower_bound, converged, n_iter = -np.inf, False, 0
        for n_iter in range(1, self.max_iter + 1):
            prev = lower_bound
            wlp = self._weighted_log_prob(X, params)
            norm = torch.logsumexp(wlp, dim=1)
            resp = torch.exp(wlp - norm[:, None])
            nk, means, cov = _gaussian_parameters(X, resp)
            params = (nk / nk.sum(), means, cov, _precision_cholesky(cov))
            lower_bound = float(norm.mean())
            if abs(lower_bound - prev) < self.tol:
                converged = True
                break
        self.weights_, self.means_, self.covariances_, self.precisions_cholesky_ = (
            p.cpu().numpy() for p in params)
        self.converged_, self.n_iter_, self.lower_bound_ = converged, n_iter, lower_bound
        return torch.argmax(self._weighted_log_prob(X, params), dim=1).cpu().numpy()

    def fit(self, x):
        self.fit_predict(x)
        return self

    def _params(self):
        return tuple(torch.as_tensor(p, device=self._device) for p in (
            self.weights_, self.means_, self.covariances_, self.precisions_cholesky_))

    def predict(self, x) -> np.ndarray:
        X = _as64(x, self._device)
        return torch.argmax(self._weighted_log_prob(X, self._params()), dim=1).cpu().numpy()
