"""The port's latent analyses against the JAX package's (and sklearn's) on
the CPU: PCA, k-means and the Gaussian mixture (`analysis/cluster.py`)
against scikit-learn, through the JAX package's `cluster_latents` and a
model carried across; the distances and the Voronoi regions; UMAP's graph,
its layout epoch from the same state, its transform, its ties and its
determinism; `CvEvaluator` and its metrics; and the four analysis stages
through both CLIs on the particle files the JAX package wrote, and on a
host without sklearn, PIL and matplotlib.

Tolerances: labels and assignments equal; PCA projections and explained
variance within 1e-9 relative (the sign rule makes the signs equal);
cluster centres and means within 1e-9 of their scale; distances within
1e-6 relative (float32 inputs, as the JAX package computes them); the
UMAP graph within 1e-12 relative; one layout epoch within 1e-5 of the
embedding's scale. Whole layouts are not compared point by point: XLA's
and torch's float32 pow differ in the last bit for about 1.6 % of inputs,
and the repulsion multiplies a difference by up to 2b/0.001 ≈ 1800, so
two roundings are 0.2-2 apart after 10 epochs on a layout of ±15 (ROADMAP
§C); whole fits are held to what a layout must show instead. Tiny sizes:
2-3 classes of 12-32 particles, d ≤ 16, UMAP at ≤ 40 epochs but one
default fit."""

import json
import pickle
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans as SkKMeans
from sklearn.decomposition import PCA as SkPCA
from sklearn.exceptions import ConvergenceWarning
from sklearn.metrics import auc as sk_auc
from sklearn.metrics import roc_curve as sk_roc_curve
from sklearn.mixture import GaussianMixture as SkGaussianMixture

from gan_discovery_pso_tpu.analysis import latent as jlatent
from gan_discovery_pso_tpu.analysis import umap_impl as jumap
from gan_discovery_pso_tpu.analysis.reporting import CvEvaluator as JCvEvaluator
from gan_discovery_pso_tpu.cli.main import main as jax_cli_main
from gan_discovery_pso_tpu.data.xlsx import read_xlsx as jax_read_xlsx
from gan_discovery_pso_tpu.pso.io import save_particle_histories as jax_save_particles
from gan_discovery_pso_tpu_torch.analysis import cluster, latent, reporting, umap_impl
from gan_discovery_pso_tpu_torch.analysis.cluster import PCA, GaussianMixture, KMeans
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.compat import cluster_model_from_sklearn

REPO = Path(__file__).resolve().parents[1]
CFG = "configs/dcgan_mnist.yaml"
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (the suite runs six
    workers on shared cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _quiet_sklearn():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ConvergenceWarning)
        yield


def _clouds(n_per, d, k, seed, spread=3.0, dup=0):
    """k Gaussian clouds of n_per points in d dims; `dup` rows repeated
    (a converged swarm holds duplicate particles)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * spread
    x = np.concatenate([c + rng.randn(n_per, d) for c in centers])
    if dup:
        x[-dup:] = x[:dup]
    return x


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-300))


# -- PCA, k-means, the Gaussian mixture ----------------------------------------


@pytest.mark.parametrize("n,d,k", [(40, 6, 2), (64, 6, 6), (30, 16, 16), (256, 2, 2),
                                   (96, 16, 2)])
def test_pca_matches_sklearn(n, d, k):
    """Both of sklearn's exact solvers ("full" below 10·d rows, else
    "covariance_eigh"), the sign rule, transform and the variances."""
    x = _clouds(n // 2, d, 2, n + d) * np.linspace(1, 3, d)
    want = SkPCA(k)
    got = PCA(k, device=CPU)
    assert _rel(got.fit_transform(x), want.fit_transform(x)) < 1e-9
    assert got.solver_ == want._fit_svd_solver
    assert _rel(got.explained_variance_, want.explained_variance_) < 1e-9
    assert _rel(got.components_, want.components_) < 1e-9
    new = x[:5] + 0.5
    assert _rel(got.transform(new), want.transform(new)) < 1e-9


@pytest.mark.parametrize("n_per,d,k,seed,dup", [(20, 6, 3, 0, 0), (32, 16, 8, 42, 0),
                                                (32, 2, 8, 42, 0), (16, 5, 2, 1, 6),
                                                (10, 3, 4, 7, 0)])
def test_kmeans_matches_sklearn(n_per, d, k, seed, dup):
    x = _clouds(n_per, d, k, seed, dup=dup)
    want = SkKMeans(init="k-means++", n_clusters=k, random_state=seed, n_init=10).fit(x)
    got = KMeans(k, n_init=10, random_state=seed, device=CPU).fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.n_iter_ == want.n_iter_
    assert abs(got.inertia_ - want.inertia_) <= 1e-9 * want.inertia_
    assert _rel(got.cluster_centers_, want.cluster_centers_) < 1e-9
    ood = np.random.RandomState(seed + 1).randn(20, d) * 3
    np.testing.assert_array_equal(got.predict(ood), want.predict(ood))


@pytest.mark.parametrize("n_per,d,k,seed", [(20, 6, 3, 0), (32, 16, 8, 42), (32, 2, 8, 42),
                                            (16, 5, 2, 1)])
def test_gaussian_mixture_matches_sklearn(n_per, d, k, seed):
    """The k-means++ 1-iteration mixture that seeds means_init, then the
    full fit from sklearn's own k-means responsibilities."""
    x = _clouds(n_per, d, k, seed)
    m0 = SkGaussianMixture(k, init_params="k-means++", tol=1e-9, max_iter=1,
                           random_state=seed).fit(x).means_
    m1 = GaussianMixture(k, init_params="k-means++", tol=1e-9, max_iter=1, random_state=seed,
                         device=CPU).fit(x).means_
    assert _rel(m1, m0) < 1e-9
    want = SkGaussianMixture(k, means_init=m0, tol=1e-9, max_iter=2000, random_state=seed)
    got = GaussianMixture(k, means_init=m1, tol=1e-9, max_iter=2000, random_state=seed,
                          device=CPU)
    np.testing.assert_array_equal(got.fit_predict(x), want.fit_predict(x))
    assert got.n_iter_ == want.n_iter_ and got.converged_ == want.converged_
    assert _rel(got.means_, want.means_) < 1e-9
    assert _rel(got.weights_, want.weights_) < 1e-9
    ood = np.random.RandomState(seed + 1).randn(20, d) * 3
    np.testing.assert_array_equal(got.predict(ood), want.predict(ood))


@pytest.mark.parametrize("algorithm", ["kmeans", "em", "expectation_maximization"])
def test_cluster_latents_matches_jax(algorithm):
    """The JAX package's cluster_latents (sklearn) and assign_to_clusters,
    against the port's, and a fitted sklearn model carried across."""
    x = _clouds(24, 6, 3, 5)
    ood = np.random.RandomState(9).randn(30, 6) * 3
    jl, jc, jm = jlatent.cluster_latents(x, algorithm, 3, seed=42)
    tl, tc, tm = latent.cluster_latents(x, algorithm, 3, seed=42, device=CPU)
    np.testing.assert_array_equal(tl, jl)
    assert _rel(tc, jc) < 1e-9
    want = jlatent.assign_to_clusters(jm, ood)
    np.testing.assert_array_equal(latent.assign_to_clusters(tm, ood), want)
    carried = cluster_model_from_sklearn(jm, device=CPU)
    np.testing.assert_array_equal(latent.assign_to_clusters(carried, ood), want)
    # the port's model pickles and, moved to a device, predicts after the round trip
    np.testing.assert_array_equal(pickle.loads(pickle.dumps(tm)).to(CPU).predict(ood), want)
    with pytest.raises(ValueError):
        latent.get_clustering_algorithm("bogus", 2, device=CPU)


@pytest.mark.parametrize("algorithm", ["kmeans", "em", "pca"])
def test_pickled_model_keeps_no_device(monkeypatch, algorithm):
    """A pickle keeps no device: a model fitted on one device loads on any
    host, computes on the card there unless `.to()` names another device,
    and raises on a host without CUDA rather than quietly using the CPU."""
    x = _clouds(12, 4, 3, 2)
    if algorithm == "pca":
        model = PCA(2, device=CPU).fit(x)
        apply = "transform"
    else:
        model = latent.get_clustering_algorithm(algorithm, 3, device=CPU).fit(x)
        apply = "predict"
    want = getattr(model, apply)(x)
    loaded = pickle.loads(pickle.dumps(model))
    assert model.device == CPU and loaded.device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(loaded, apply)(x)
    np.testing.assert_array_equal(getattr(loaded.to(CPU), apply)(x), want)


def test_layout_draws_without_device_raise_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        umap_impl.layout_draws(2, 8, 5, 4, 0)
    draws = umap_impl.layout_draws(2, 8, 5, 4, 0, device=CPU)
    assert draws.uniform.shape == (2, 8) and draws.negatives.shape == (2, 8, 5)


def test_carry_across_refuses_other_mixtures():
    g = SkGaussianMixture(2, covariance_type="diag", random_state=0).fit(_clouds(10, 3, 2, 0))
    with pytest.raises(ValueError, match="full-covariance"):
        cluster_model_from_sklearn(g)


# -- distances and Voronoi -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_distances_match_jax(dtype):
    rng = np.random.RandomState(2)
    a, b = (rng.randn(40, 16) * 3 + 5).astype(dtype), (rng.randn(25, 16) * 3).astype(dtype)
    got = latent.mutual_distance(a, b, device=CPU)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, jlatent.mutual_distance(a, b), rtol=1e-6)
    np.testing.assert_allclose(latent.pairwise_distances(a, device=CPU),
                               jlatent.pairwise_distances(a), rtol=1e-6)
    loop = np.array([np.linalg.norm(x - y) for x in a.astype(np.float64) for y in b])
    np.testing.assert_allclose(got, loop, rtol=1e-5 if dtype == np.float32 else 1e-9)


def test_voronoi_and_pca_project_match_jax():
    pts = np.random.RandomState(3).randn(12, 2)
    regions, vertices = latent.voronoi_finite_polygons(pts)
    jregions, jvertices = jlatent.voronoi_finite_polygons(pts)
    assert [list(map(int, r)) for r in regions] == [list(map(int, r)) for r in jregions]
    np.testing.assert_array_equal(vertices, jvertices)
    x = _clouds(20, 6, 2, 4)
    assert _rel(latent.pca_project(x, 2, device=CPU), jlatent.pca_project(x, 2)) < 1e-9
    emb, tag = latent.umap_project(x, 2, device=CPU)
    assert emb.shape == (40, 2) and tag == "umap" and np.isfinite(emb).all()


# -- UMAP ------------------------------------------------------------------------------


def jax_layout_draws(n_epochs, e, neg, n_ref, seed):
    """JAX's per-epoch draws at its padded edge count (umap_impl.py:257-266,
    175-187), for the port to take the first e rows of."""
    e_pad = max(256, 1 << (e - 1).bit_length())
    key = jax.random.key(seed)
    us, ns = [], []
    for ep in range(n_epochs):
        k1, k2 = jax.random.split(jax.random.fold_in(key, ep))
        us.append(np.asarray(jax.random.uniform(k1, (e_pad,))))
        ns.append(np.asarray(jax.random.randint(k2, (e_pad, neg), 0, n_ref)))
    return umap_impl.LayoutDraws(torch.tensor(np.stack(us)), torch.tensor(np.stack(ns)))


@pytest.mark.parametrize("n_per,d,k", [(20, 6, 10), (32, 16, 15)])
def test_umap_graph_matches_jax(n_per, d, k):
    x = _clouds(n_per, d, 2, d)
    (jidx, jrho, jsig), (jh, jt, jw) = jumap.UMAP(n_neighbors=k)._build_graph(x)
    (idx, rho, sig), (h, t, w) = umap_impl.UMAP(n_neighbors=k, device=CPU).build_graph(
        torch.as_tensor(x))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(rho.numpy(), jrho, rtol=1e-12)
    np.testing.assert_allclose(sig.numpy(), jsig, rtol=1e-12)
    np.testing.assert_array_equal(h.numpy(), jh)
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-12)


def _one_jax_epoch(y0, ref, heads, tails, probs, key_seed, move_tail):
    """One epoch of the JAX package's layout program from y0."""
    a, b = jumap.find_ab_params(1.0, 0.1)
    e = len(heads)
    e_pad = max(256, 1 << (e - 1).bit_length())
    pad = e_pad - e
    run = jumap._layout_fn(1, 5, move_tail, ref is not None)
    return np.asarray(run(
        jnp.asarray(y0, jnp.float32), jnp.asarray(y0 if ref is None else ref, jnp.float32),
        jnp.asarray(np.r_[heads, np.zeros(pad, np.int64)], jnp.int32),
        jnp.asarray(np.r_[tails, np.zeros(pad, np.int64)], jnp.int32),
        jnp.asarray(np.r_[probs, np.zeros(pad)], jnp.float32),
        jnp.asarray([a, b, 1.0], jnp.float32), jax.random.key(key_seed)))


@pytest.mark.parametrize("epochs_before", [0, 5, 40])
def test_umap_layout_epoch_matches_jax_from_the_same_state(epochs_before):
    """From JAX's layout after 0, 5 and 40 epochs, one epoch in each
    package with JAX's draws: within 1e-5 of the embedding's scale."""
    x = _clouds(32, 16, 2, 11)
    state = jumap.UMAP(n_epochs=epochs_before, random_state=0).fit_transform(x)
    _, (h, t, w) = jumap.UMAP()._build_graph(x)
    probs = w / w.max()
    want = _one_jax_epoch(state, None, h, t, probs, 3, True)
    a, b = jumap.find_ab_params(1.0, 0.1)
    draws = jax_layout_draws(1, len(h), 5, len(x), 3)
    got = umap_impl.optimize_layout(
        torch.tensor(state), None, torch.as_tensor(h), torch.as_tensor(t),
        torch.as_tensor(probs, dtype=torch.float32), a, b, 1.0,
        umap_impl.LayoutDraws(draws.uniform[:, :len(h)], draws.negatives[:, :len(h)]))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * np.abs(want).max()
    assert not np.array_equal(want, state)  # the epoch moved the layout


def test_umap_fit_init_and_transform_match_jax():
    """The fit's PCA init (0 epochs) equal to JAX's; the transform's
    weighted-mean init, and one epoch of it against the frozen embedding,
    within 1e-5 of the scale."""
    x = _clouds(20, 6, 2, 12)
    new = x[:7] + np.random.RandomState(1).randn(7, 6) * 0.3
    j0 = jumap.UMAP(n_neighbors=10, n_epochs=0, random_state=0)
    t0 = umap_impl.UMAP(n_neighbors=10, n_epochs=0, random_state=0, device=CPU)
    np.testing.assert_array_equal(t0.fit_transform(x), j0.fit_transform(x))
    j = jumap.UMAP(n_neighbors=10, n_epochs=20, random_state=0).fit(x)
    t = umap_impl.UMAP(n_neighbors=10, n_epochs=20, random_state=0, device=CPU).fit(x)
    t.embedding_ = j.embedding_  # the same frozen embedding for both transforms
    d = jumap._pairwise_dists(new, x)
    idx = np.argsort(d, axis=1, kind="stable")[:, :10]
    nd = np.take_along_axis(d, idx, axis=1)
    rho, sigma = jumap._smooth_knn(nd, 10)
    wts = jumap._memberships(nd, rho, sigma)
    wts = wts / wts.sum(axis=1, keepdims=True)
    init = np.einsum("nk,nkc->nc", wts, j.embedding_[idx])
    heads, tails = np.repeat(np.arange(7), 10), idx.ravel()
    want = _one_jax_epoch(init, j.embedding_, heads, tails, wts.ravel(), 1, False)
    draws = jax_layout_draws(30, len(heads), 5, len(x), 1)
    got = t.transform(new, draws=draws)
    a, b = jumap.find_ab_params(1.0, 0.1)
    step = umap_impl.optimize_layout(
        torch.as_tensor(init, dtype=torch.float32), torch.as_tensor(j.embedding_),
        torch.as_tensor(heads), torch.as_tensor(tails),
        torch.as_tensor(wts.ravel() / wts.max(), dtype=torch.float32), a, b, 1.0,
        umap_impl.LayoutDraws(draws.uniform[:1, :70], draws.negatives[:1, :70]),
        move_tail=False)
    want = _one_jax_epoch(init, j.embedding_, heads, tails, wts.ravel() / wts.max(), 1, False)
    assert float(np.abs(step.numpy() - want).max()) <= 1e-5 * np.abs(want).max()
    assert got.shape == (7, 2) and np.isfinite(got).all()


def test_umap_ties_go_to_the_lower_index():
    """Duplicate particles: the port's neighbours come from a stable sort
    (ties to the lower index); JAX's argsort is not stable, so only the
    rows whose k-th and (k+1)-th distances do not tie are compared."""
    x = _clouds(16, 6, 2, 13, dup=8)
    k = 10
    idx, dists = umap_impl._knn(torch.as_tensor(x), k)
    jidx, _ = jumap._knn(x, k)
    full = np.sort(jumap._pairwise_dists(x, x) + np.diag(np.full(len(x), np.inf)), axis=1)
    tied = full[:, k - 1] == full[:, k]
    assert tied.sum() >= 1  # the duplicates make ties
    for row in np.nonzero(~tied)[0]:
        assert set(idx[row].tolist()) == set(jidx[row].tolist())
    d = umap_impl.pairwise_dists(torch.as_tensor(x), torch.as_tensor(x))
    d.fill_diagonal_(float("inf"))
    for row in range(len(x)):
        order = sorted(range(len(x)), key=lambda j: (float(d[row, j]), j))[:k]
        assert idx[row].tolist() == order


def test_umap_fits_keep_blobs_apart_and_rerun_bit_equal():
    """What a layout must show (the JAX package's own test): the two blobs
    apart after 40 epochs and after one default fit (200 epochs); new
    points of blob A land nearer A; a rerun is bit-equal."""
    x = np.vstack([_clouds(40, 5, 1, 0) * 0 + np.random.RandomState(0).randn(40, 5) + 3,
                   np.random.RandomState(1).randn(40, 5) - 3])
    for n_epochs in (40, 200):
        um = umap_impl.UMAP(n_neighbors=10, n_epochs=n_epochs, random_state=0, device=CPU)
        emb = um.fit_transform(x)
        ca, cb = emb[:40].mean(0), emb[40:].mean(0)
        spread = max(emb[:40].std(), emb[40:].std(), 1e-6)
        assert np.linalg.norm(ca - cb) > 2.0 * spread
    again = umap_impl.UMAP(n_neighbors=10, n_epochs=200, random_state=0, device=CPU)
    np.testing.assert_array_equal(again.fit_transform(x), emb)
    t = um.transform(np.random.RandomState(3).randn(10, 5) + 3)
    assert ((np.linalg.norm(t - ca, axis=1) < np.linalg.norm(t - cb, axis=1)).mean() >= 0.9)
    spec = umap_impl.UMAP(n_neighbors=10, n_epochs=40, init="spectral", device=CPU)
    assert np.isfinite(spec.fit_transform(x)).all()
    with pytest.raises(ValueError):
        umap_impl.UMAP(init="bogus", device=CPU)


# -- CvEvaluator -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roc_metrics_match_sklearn(seed):
    rng = np.random.RandomState(seed)
    for _ in range(30):
        n = rng.randint(2, 50)
        y, s = rng.randint(0, 2, n), np.round(rng.rand(n), rng.randint(1, 4))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = sk_roc_curve(y, s)
        for got_part, want_part in zip(reporting.roc_curve(y, s), want):
            np.testing.assert_array_equal(got_part, want_part)
        if len(np.unique(y)) == 2:
            assert reporting.auc(want[0], want[1]) == sk_auc(want[0], want[1])


def test_cv_evaluator_matches_jax(tmp_path):
    """fold_metrics, summary and results.xlsx against the JAX package's
    (sklearn metrics), a single-class fold's NaN AUC included."""
    rng = np.random.RandomState(8)
    folds = [(rng.randint(0, 2, 60), rng.rand(60)) for _ in range(3)]
    folds.append((np.ones(5, int), np.array([0.9, 0.8, 0.7, 0.2, 0.6])))
    got, want = reporting.CvEvaluator(), JCvEvaluator()
    for y, s in folds:
        got.add_fold(y, s)
        want.add_fold(y, s)
    g, w = got.fold_metrics(), want.fold_metrics()
    assert np.isnan(g[-1]["auc"]) and g[-1]["recall"] == 0.8
    for gr, wr in zip(g, w):
        assert gr.keys() == wr.keys()
        for key in gr:
            np.testing.assert_allclose(gr[key], wr[key], rtol=1e-12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_allclose(list(got.summary().values()),
                                   list(want.summary().values()), rtol=1e-12)
    assert jax_read_xlsx(got.write_results_xlsx(tmp_path / "a.xlsx")) == \
        jax_read_xlsx(want.write_results_xlsx(tmp_path / "b.xlsx"))
    assert got.plot_mean_roc(tmp_path / "m.png").exists()
    assert got.plot_roc(tmp_path / "r.png").exists()
    assert pickle.loads(got.save_overall_scores(tmp_path / "s.pkl").read_bytes())[1] == []


def test_report_writers_write_their_files(tmp_path):
    """The writers the stages call where matplotlib is installed, and
    `image_grid`, which no stage calls."""
    rng = np.random.RandomState(6)
    pts, labs = rng.randn(30, 2), np.repeat([0, 1, 2], 10)
    cov = np.stack([np.eye(2) * (i + 1) for i in range(3)])
    d = {"0": np.abs(rng.randn(40)), "mutual": np.abs(rng.randn(40))}
    paths = [
        reporting.plot_scatter_2d(pts, labs, tmp_path / "s.png", centers=pts[:3],
                                  extra=pts[3:6]),
        reporting.plot_pca_variance(np.array([3.0, 2.0, 1.0]), tmp_path / "v.png"),
        reporting.plot_ellipsoids(pts, labs, pts[:3], cov, tmp_path / "e.png", "pca"),
        reporting.plot_voronoi(pts[:10], tmp_path / "vor.png", labels=labs[:10]),
        reporting.plot_distance_histogram(d["0"], tmp_path / "h.png"),
        reporting.plot_sorted_distance_curves(d, tmp_path / "c.png"),
        reporting.plot_distance_kde(d, tmp_path / "k.png"),
        reporting.image_grid(rng.rand(10, 1, 28, 28), tmp_path / "g.png"),
    ]
    assert all(p.exists() and p.stat().st_size > 0 for p in paths)


# -- the stages through both CLIs --------------------------------------------------------


@pytest.fixture(scope="module")
def particles(tmp_path_factory):
    """Particle files the JAX package wrote: IiD classes 0 and 2 (3 rows
    of 12 particles, d = 6, and d = 2), OoD classes 1 and 5 and the
    inverted patient 1."""
    root = tmp_path_factory.mktemp("particles")
    rng = np.random.RandomState(7)
    for d in (6, 2):
        for label, off in ((0, -3.0), (2, 3.0)):
            traj = (rng.randn(3, 12, d) + off).astype(np.float32)
            jax_save_particles(root / f"iid{d}", label, traj, np.zeros_like(traj), "iid")
        for label, off in ((1, 3.0), (5, -3.0)):
            traj = (rng.randn(2, 8, d) + off).astype(np.float32)
            jax_save_particles(root / f"ood{d}", label, traj, np.zeros_like(traj), "ood")
    return root


def _both(tmp_path, stage, *args, sets=()):
    """Run the stage through the JAX CLI and the port's (--device cpu) with
    the same arguments; return each run's (reports, models) dirs."""
    out = {}
    for name, main, extra in (("jax", jax_cli_main, ()), ("port", cli_main, ("--device", CPU))):
        roots = {k: tmp_path / name / k for k in ("reports", "model", "interim")}
        argv = [stage, "--cfg", CFG, *args, *extra, "--set", "data.iid_classes=[0,2]",
                "data.ood_classes=[1,5]", *sets,
                *(f"data.{k}_dir={v}" for k, v in roots.items())]
        assert main(argv) == 0
        module = f"00001--{stage.replace('-', '_')}"
        out[name] = (roots["reports"] / "mnist" / module, roots["model"] / "mnist" / module)
    return out


def _files(run_dir: Path) -> set:
    return {str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file()}


def test_pso_analysis_stage_matches_jax(tmp_path, particles):
    """The JAX stage's sklearn PCA of the float32 particles runs in
    float32; the port's runs in float64: within 1e-9 of sklearn's float64
    PCA of the same particles, within 1e-5 (float32's rounding) of the
    JAX stage's."""
    runs = _both(tmp_path, "pso-analysis", "--path-pso", str(particles / "iid6"))
    (jrep, _), (trep, _) = runs["jax"], runs["port"]
    assert _files(trep) == _files(jrep)
    with open(jrep / "general" / "overall_history.pkl", "rb") as f:
        want = pickle.load(f)
    with open(trep / "general" / "overall_history.pkl", "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    final = np.concatenate([np.load(particles / "iid6" / f"particles_iid_class_{c}.npz")
                            ["positions"][-1] for c in (0, 2)])
    assert _rel(got["pca"], SkPCA(2).fit_transform(final.astype(np.float64))) < 1e-9
    assert _rel(got["pca"], want["pca"]) < 1e-5
    assert got["umap"].shape == want["umap"].shape and np.isfinite(got["umap"]).all()
    assert json.loads((trep / "timing.json").read_text()).keys() == \
        json.loads((jrep / "timing.json").read_text()).keys()


@pytest.mark.parametrize("algorithm,d", [("kmeans", 6), ("em", 2)])
def test_pso_analysis_clustering_stage_matches_jax(tmp_path, particles, algorithm, d):
    runs = _both(tmp_path, "pso-analysis-clustering", "--path-pso", str(particles / f"iid{d}"),
                 "--path-ood-pso", str(particles / f"ood{d}"),
                 sets=(f"trainer_pso_analysis.clustering_algorithm={algorithm}",))
    (jrep, jmod), (trep, tmod) = runs["jax"], runs["port"]
    assert _files(trep) == _files(jrep)
    assert json.loads((trep / "ood_cluster_assignment.json").read_text()) == \
        json.loads((jrep / "ood_cluster_assignment.json").read_text())
    with open(jmod / f"{algorithm}.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmod / f"{algorithm}.pkl", "rb") as f:
        got = pickle.load(f)
    assert type(got).__module__ == "gan_discovery_pso_tpu_torch.analysis.cluster"
    centers = "cluster_centers_" if algorithm == "kmeans" else "means_"
    assert _rel(getattr(got, centers), getattr(want, centers)) < 1e-9
    ood = np.random.RandomState(0).randn(50, d) * 4
    np.testing.assert_array_equal(got.to(CPU).predict(ood), want.predict(ood))


def test_pso_analysis_distance_stage_matches_jax(tmp_path, particles):
    runs = _both(tmp_path, "pso-analysis-distance", "--path-pso", str(particles / "iid6"))
    (jrep, _), (trep, _) = runs["jax"], runs["port"]
    assert _files(trep) == _files(jrep)
    got = json.loads((trep / "distance_summary.json").read_text())
    want = json.loads((jrep / "distance_summary.json").read_text())
    assert got.keys() == want.keys()
    for key in want:
        for stat in ("mean", "std"):
            assert abs(got[key][stat] - want[key][stat]) <= 1e-6 * abs(want[key][stat])


def test_pso_inverter_analysis_stage_matches_jax(tmp_path, particles):
    runs = _both(tmp_path, "pso-inverter-analysis", "--path-pso", str(particles / "iid6"),
                 "--path-ood-pso", str(particles / "ood6"), "--ood-patient", "1",
                 sets=("trainer_pso_analysis.clustering_algorithm=kmeans",))
    (jrep, jmod), (trep, tmod) = runs["jax"], runs["port"]
    assert _files(trep) == _files(jrep)
    name = "ood_patient_1_cluster_assignment.json"
    assert json.loads((trep / name).read_text()) == json.loads((jrep / name).read_text())
    assert (tmod / "kmeans.pkl").exists()


def test_analysis_stages_run_without_sklearn_pil_or_matplotlib(tmp_path, particles):
    """The card's host has none of the three: every computation runs and
    the JSON artifacts equal those of a run that has them."""
    code = textwrap.dedent(f"""
        import sys
        for missing in ("sklearn", "PIL", "matplotlib"):
            sys.modules[missing] = None
        from gan_discovery_pso_tpu_torch.cli.main import main
        p = {str(particles)!r}
        common = ["--cfg", {CFG!r}, "--device", "cpu", "--set", "data.iid_classes=[0,2]",
                  "data.ood_classes=[1,5]", "trainer_pso_analysis.clustering_algorithm=em"]
        root = {str(tmp_path)!r}
        for stage, args in (("pso-analysis", ["--path-pso", p + "/iid6"]),
                            ("pso-analysis-clustering", ["--path-pso", p + "/iid2",
                                                         "--path-ood-pso", p + "/ood2"]),
                            ("pso-analysis-distance", ["--path-pso", p + "/iid6"]),
                            ("pso-inverter-analysis", ["--path-pso", p + "/iid6",
                                                       "--path-ood-pso", p + "/ood6"])):
            dirs = [f"data.{{k}}_dir={{root}}/{{k}}" for k in ("reports", "model", "interim")]
            assert main([stage, *args, *common, *dirs]) == 0, stage
        assert "sklearn" not in [m for m in sys.modules if sys.modules[m] is not None]
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "not writing plots" in proc.stdout and "matplotlib is not installed" in proc.stdout
    reports = tmp_path / "reports" / "mnist"
    assert not list(reports.rglob("*.png"))
    runs = _both(tmp_path / "with", "pso-analysis-clustering", "--path-pso",
                 str(particles / "iid2"), "--path-ood-pso", str(particles / "ood2"),
                 sets=("trainer_pso_analysis.clustering_algorithm=em",))
    name = "ood_cluster_assignment.json"
    assert json.loads((reports / "00001--pso_analysis_clustering" / name).read_text()) == \
        json.loads((runs["port"][0] / name).read_text())
    assert (reports / "00001--pso_inverter_analysis" /
            "ood_patient_1_cluster_assignment.json").exists()
    assert (reports / "00001--pso_analysis" / "general" / "overall_history.pkl").exists()
    assert (reports / "00001--pso_analysis_distance" / "distance_summary.json").exists()
