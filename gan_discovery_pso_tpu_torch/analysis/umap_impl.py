"""UMAP (McInnes, Healy & Melville 2018) from scratch, on the device
(counterpart of `gan_discovery_pso_tpu/analysis/umap_impl.py`: `_knn` :47,
`_smooth_knn` :56, `_memberships` :84, `find_ab_params` :88,
`_spectral_init` :98, the layout `_layout_fn` :140-190, `UMAP` :193 with
`fit` :288 and `transform` :328).

The published algorithm:
1. exact kNN from one pairwise-distance product (float64, the device);
2. smooth-kNN calibration: rho_i, the nearest positive distance, and
   sigma_i by 64 bisection steps so that Σ_j exp(−(d_ij − rho_i)⁺/sigma_i)
   = log2(k) (the device);
3. the fuzzy simplicial set: memberships w_ij, symmetrised by the t-conorm
   W + Wᵀ − W∘Wᵀ (the device);
4. (a, b) fitted to the min_dist curve (scipy `curve_fit`, the host) and
   the spectral init (scipy `eigsh`, the host), or PCA
   (`analysis/cluster.py`);
5. the cross-entropy layout by per-epoch edge sampling with negative
   sampling, vectorised over all edges, in float32 on the device, one
   epoch a Python iteration.

Draws and determinism:
- torch cannot replay threefry, so each epoch's Bernoulli uniforms [e] and
  negative indices [e, neg] are an input (`LayoutDraws`); without one they
  come from a torch generator on the fit's device seeded by the fit's key
  (a rerun draws the same; the card and the CPU draw differently, so a
  check of one against the other feeds both the same draws). A parity
  test feeds JAX's draws: the first e rows of those JAX makes at its
  padded edge count.
- `y.at[idx].add(v)` is `index_put_(accumulate=True)`, which adds the
  updates of one row in their order, on the CPU and (sorted stably by
  index) on CUDA: a rerun is bit-equal.
- Neighbours come from a stable sort, ties to the lower index. The JAX
  package sorts with numpy's unstable argsort, so where the k-th and
  (k+1)-th distances tie (a converged swarm holds duplicate particles)
  its neighbour order is arbitrary in JAX itself.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity

F64 = torch.float64


class LayoutDraws(NamedTuple):
    """Per epoch: the edge-activation uniforms [n_epochs, e] (float32) and
    the negative samples' indices [n_epochs, e, neg] into the reference
    embedding."""

    uniform: torch.Tensor
    negatives: torch.Tensor


def layout_draws(n_epochs: int, n_edges: int, neg: int, n_ref: int, seed: int,
                 device=None) -> LayoutDraws:
    """A fit's draws from a torch generator on `device` (the card when
    None) seeded by `seed`."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    return LayoutDraws(
        torch.rand(n_epochs, n_edges, generator=g, device=device),
        torch.randint(0, n_ref, (n_epochs, n_edges, neg), generator=g, device=device))


def pairwise_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a_i − b_j‖ [Na, Nb] by the expanded form in the inputs' dtype, the
    product without TF32, as the JAX package's `mutual_distance` (also the
    port's, `analysis/latent.py`)."""
    with fp32_parity():
        cross = a @ b.T
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * cross
    return torch.sqrt(sq.clamp_min(0.0))


def _knn(x: torch.Tensor, k: int, exclude_self: bool = True):
    """Exact kNN: (indices [N, k], distances [N, k]), nearest first, ties to
    the lower index."""
    d = pairwise_dists(x, x)
    if exclude_self:
        d.fill_diagonal_(float("inf"))
    idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return idx, torch.gather(d, 1, idx)


def _smooth_knn(dists: torch.Tensor, k: int, n_iter: int = 64):
    """Per point (rho, sigma): rho the nearest positive distance (0 where
    there is none), sigma by bisection for Σ_j exp(−(d_j − rho)⁺/sigma) =
    log2(k), floored at 1e-3 of the mean distance (umap-learn's
    MIN_K_DIST_SCALE)."""
    n = dists.shape[0]
    pos = torch.where(dists > 0, dists, torch.full_like(dists, float("inf")))
    rho = pos.min(dim=1).values
    rho = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))
    target = np.log2(k)
    adj = (dists - rho[:, None]).clamp_min(0.0)
    lo = torch.zeros(n, dtype=dists.dtype, device=dists.device)
    hi = torch.full((n,), float("inf"), dtype=dists.dtype, device=dists.device)
    sigma = torch.ones(n, dtype=dists.dtype, device=dists.device)
    for _ in range(n_iter):
        psum = torch.exp(-adj / sigma[:, None]).sum(dim=1)
        too_big = psum > target
        hi = torch.where(too_big, sigma, hi)
        lo = torch.where(too_big, lo, sigma)
        sigma = torch.where(torch.isfinite(hi), (lo + hi) / 2.0, sigma * 2.0)
    return rho, torch.maximum(sigma, 1e-3 * dists.mean())


def _memberships(dists: torch.Tensor, rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return torch.exp(-(dists - rho[:, None]).clamp_min(0.0) / sigma[:, None])


@functools.lru_cache(maxsize=8)
def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
    """Fit 1/(1 + a·d^(2b)) to the piecewise target curve (paper §3.2)."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0.0, spread * 3.0, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2.0 * b)), xv, yv)
    return float(a), float(b)


def _spectral_init(n: int, edges, n_components: int) -> np.ndarray | None:
    """Eigenvectors 2..n_components+1 of the symmetric-normalised Laplacian
    I − D^-1/2 W D^-1/2 of the fuzzy graph (umap-learn's default init), on
    the host; None on a disconnected graph, too few points or no ARPACK
    convergence, where the caller takes PCA."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    from scipy.sparse.linalg import ArpackError, ArpackNoConvergence, eigsh

    heads, tails, weights = (np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t)
                             for t in edges)
    k = n_components + 1
    if n <= k + 1:
        return None
    g = sp.coo_matrix((weights, (heads, tails)), shape=(n, n)).tocsr()
    ncc, _ = connected_components(g, directed=False)
    if ncc > 1:
        return None
    deg = np.asarray(g.sum(axis=1)).ravel()
    dinv = sp.diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
    lap = sp.identity(n, format="csr") - dinv @ g @ dinv
    try:
        vals, vecs = eigsh(lap, k, which="SM", v0=np.ones(n),
                           ncv=min(n, max(2 * k + 1, int(np.sqrt(n)))),
                           tol=1e-4, maxiter=n * 5)
    except (ArpackError, ArpackNoConvergence):
        return None
    order = np.argsort(vals)
    return np.asarray(vecs[:, order[1:k]], np.float64)


def optimize_layout(y0: torch.Tensor, ref: torch.Tensor | None, heads: torch.Tensor,
                    tails: torch.Tensor, probs: torch.Tensor, a: float, b: float, lr: float,
                    draws: LayoutDraws, move_tail: bool = True, epochs=None) -> torch.Tensor:
    """The JAX package's `_layout_fn` body, one epoch a Python iteration, in
    float32. `ref` is None for a fit (tails index y itself) or the frozen
    embedding of a transform (only heads move). `epochs` (default: all of
    the draws' rows) runs only those epochs from y0, so that one epoch can
    be held against another device's from the same state. Returns the
    embedding."""
    n_epochs = draws.uniform.shape[0]
    f32 = np.float32
    a32, b32 = torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
    a32, b32 = a32.to(y0.device), b32.to(y0.device)
    y = y0.clone()
    hidx, tidx = (heads,), (tails,)
    for ep in range(n_epochs) if epochs is None else epochs:
        alpha = float(f32(lr) * (f32(1.0) - f32(ep) / f32(n_epochs)))
        active = (draws.uniform[ep] < probs).to(torch.float32)
        yh = y[heads]
        yt = ref[tails] if ref is not None else y[tails]
        diff = yh - yt
        d2 = (diff * diff).sum(dim=1)
        att = (-2.0 * a32 * b32 * d2 ** (b32 - 1.0)) / (a32 * d2 ** b32 + 1.0)
        att = torch.where(d2 > 0, att, torch.zeros_like(att))
        g_att = (att[:, None] * diff).clamp(-4.0, 4.0) * active[:, None]
        y = y.index_put(hidx, alpha * g_att, accumulate=True)
        if move_tail and ref is None:
            y = y.index_put(tidx, -alpha * g_att, accumulate=True)
        yn = (ref if ref is not None else y)[draws.negatives[ep]]  # [e, neg, dim]
        diffn = y[heads][:, None, :] - yn
        d2n = (diffn * diffn).sum(dim=2)
        rep = (2.0 * b32) / ((0.001 + d2n) * (a32 * d2n ** b32 + 1.0))
        g_rep = (rep[:, :, None] * diffn).clamp(-4.0, 4.0) * active[:, None, None]
        y = y.index_put(hidx, alpha * g_rep.sum(dim=1), accumulate=True)
    return y


class UMAP:
    """The subset of umap-learn's API the analyses use: fit, fit_transform,
    transform; every fit on `device` (the card unless the caller names
    another)."""

    def __init__(self, n_components: int = 2, n_neighbors: int = 15, min_dist: float = 0.1,
                 spread: float = 1.0, n_epochs: int = 200, learning_rate: float = 1.0,
                 negative_sample_rate: int = 5, random_state: int = 42, init: str = "pca",
                 device=None):
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.spread = spread
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_sample_rate = negative_sample_rate
        self.random_state = random_state
        if init not in ("pca", "spectral"):
            raise ValueError(f"init must be 'pca' or 'spectral', not {init!r}")
        self.init = init
        self.device = str(resolve_device(device))

    def build_graph(self, x: torch.Tensor):
        """((knn idx, rho, sigma), (heads, tails, weights)) of [N, d], in float64."""
        x = x.to(F64)
        n = len(x)
        k = min(self.n_neighbors, n - 1)
        idx, dists = _knn(x, k)
        rho, sigma = _smooth_knn(dists, k)
        w = _memberships(dists, rho, sigma)
        dense = torch.zeros(n, n, dtype=F64, device=x.device)
        dense[torch.arange(n, device=x.device).repeat_interleave(k), idx.reshape(-1)] = \
            w.reshape(-1)
        sym = dense + dense.T - dense * dense.T  # the fuzzy set union
        heads, tails = torch.nonzero(sym, as_tuple=True)
        return (idx, rho, sigma), (heads, tails, sym[heads, tails])

    def _optimize(self, init: np.ndarray, edges, n_epochs: int, key_seed: int,
                  move_tail: bool = True, fixed_ref: np.ndarray | None = None,
                  draws: LayoutDraws | None = None) -> np.ndarray:
        heads, tails, weights = edges
        e = len(heads)
        if e == 0 or n_epochs == 0:
            return np.asarray(init, np.float32)
        a, b = find_ab_params(self.spread, self.min_dist)
        dev = self.device
        y0 = torch.as_tensor(np.asarray(init), dtype=torch.float32, device=dev)
        ref = None if fixed_ref is None else torch.as_tensor(
            np.asarray(fixed_ref), dtype=torch.float32, device=dev)
        n_ref = len(y0) if ref is None else len(ref)
        if draws is None:
            draws = layout_draws(n_epochs, e, int(self.negative_sample_rate), n_ref, key_seed,
                                 device=dev)
        draws = LayoutDraws(draws.uniform[:, :e].to(dev, torch.float32),
                            draws.negatives[:, :e].to(dev, torch.int64))
        probs = (weights / weights.max()).to(torch.float32)
        y = optimize_layout(y0, ref, heads, tails, probs, a, b, self.learning_rate, draws,
                            move_tail=move_tail)
        return y.cpu().numpy()

    def fit(self, x, draws: LayoutDraws | None = None):
        """Embed [N, d]; `draws` (n_epochs rows) replaces the fit's own."""
        from gan_discovery_pso_tpu_torch.analysis.cluster import PCA

        x64 = np.asarray(x, np.float64)
        self._x = torch.as_tensor(x64, device=self.device)
        if len(x64) < 2:  # a degenerate input: the trivial embedding, no graph
            self.embedding_ = np.zeros((len(x64), self.n_components), np.float32)
            return self
        (idx, rho, sigma), edges = self.build_graph(self._x)
        self._knn_idx, self._rho, self._sigma = idx, rho, sigma
        init = None
        if self.init == "spectral":
            init = _spectral_init(len(x64), edges, self.n_components)
        if init is None:
            ncomp = min(self.n_components, x64.shape[1], max(1, len(x64) - 1))
            init = PCA(ncomp, device=self.device).fit_transform(self._x)
        if init.shape[1] < self.n_components:
            init = np.hstack([init, np.zeros((len(x64), self.n_components - init.shape[1]))])
        scale = np.abs(init).max() or 1.0
        init = init / scale * 10.0
        init = init + np.random.RandomState(self.random_state).normal(0, 1e-4, init.shape)
        self.embedding_ = self._optimize(init, edges, self.n_epochs, self.random_state,
                                         draws=draws)
        return self

    def fit_transform(self, x, draws: LayoutDraws | None = None) -> np.ndarray:
        return self.fit(x, draws=draws).embedding_

    def transform(self, xnew, draws: LayoutDraws | None = None) -> np.ndarray:
        """Out-of-sample points: kNN against the training set, smooth-kNN
        memberships, the membership-weighted mean of the neighbours'
        embeddings, then 30 epochs moving only the new points against the
        frozen training embedding; `draws` (30 rows) replaces their own."""
        xn = torch.as_tensor(np.asarray(xnew, np.float64), device=self.device)
        k = min(self.n_neighbors, len(self._x))
        d = pairwise_dists(xn, self._x)
        idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
        nd = torch.gather(d, 1, idx)
        rho, sigma = _smooth_knn(nd, k)
        w = _memberships(nd, rho, sigma)
        w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)
        emb = torch.tensor(self.embedding_, dtype=F64, device=self.device)
        init = torch.einsum("nk,nkc->nc", w, emb[idx]).cpu().numpy()
        heads = torch.arange(len(xn), device=self.device).repeat_interleave(k)
        tails, weights = idx.reshape(-1), w.reshape(-1)
        good = weights > 0
        return self._optimize(init, (heads[good], tails[good], weights[good]), n_epochs=30,
                              key_seed=self.random_state + 1, move_tail=False,
                              fixed_ref=self.embedding_, draws=draws)
