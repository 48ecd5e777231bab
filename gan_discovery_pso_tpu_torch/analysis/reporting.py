"""Report artifacts of the discovery stage: convergence plots, particle
scatters, the 2-D fitness landscape, GIFs and image grids (counterpart of
`gan_discovery_pso_tpu/analysis/reporting.py`: `_savefig` and its switches
:22-79, `plot_convergence` :83, `plot_particle_dimensions` :95,
`plot_fitness_landscape_2d` :116, `make_gif` :142, `plot_mean_mse` :418,
`plot_particles_last_iteration` :431, `grid_canvas` :470,
`save_image_grid` :491, `superimage` :513, `plot_digits` :624,
`plot_cnn_training` :647) and of the inverter stages
(`plot_training_curves` :160, `save_grayscale` :244,
`plot_regularize_inverter_losses` :274, `plot_phase_losses` :677,
`recon_panel` :709), of the CAE and the classifier battery
(`denoise_panel` :256, `plot_latent_space` :560, `plot_img_latent_space`
:581, `plot_battery_tree` :606, `error_reject_curve` :966), of the DCGAN
(`plot_gan_training` :176, `plot_posterior_histograms` :291,
`plot_posterior_polarization` :778), of the VQ-VAE (`plot_vqvae_losses`
:215) and of the latent analyses (`plot_sorted_distance_curves` :329,
`plot_distance_kde` :344, `plot_ellipsoids` :366, `plot_pca_variance`
:403, `image_grid` :451, `plot_scatter_2d` :538, `plot_voronoi` :737,
`plot_distance_histogram` :764, `CvEvaluator` :795, with sklearn's
`roc_curve`, `auc`, `roc_auc_score` and confusion counts in numpy).

matplotlib and PIL are imported inside the writers, so the package imports
on a host that lacks them; the stage asks `host_has` before it calls a
writer whose package is missing.

Two environment switches, read at import as in the JAX package, keep a test
suite's hundreds of figures cheap: GDPT_PLOT_DPI_SCALE scales every raster's
dpi, and GDPT_FAST_FIGURES=1 writes a 1x1 PNG at the contracted path for
most figures (the first of each file-name pattern, digits normalised, and a
1-in-8 sample by path hash still render).
"""

from __future__ import annotations

import importlib.util
import math
import os
import re
import zlib
from pathlib import Path

import numpy as np

_DPI_SCALE = float(os.environ.get("GDPT_PLOT_DPI_SCALE", "1.0"))
_FAST_FIGURES = os.environ.get("GDPT_FAST_FIGURES", "") == "1"
_STUB_PNG: bytes | None = None
_RENDERED_PATTERNS: set[str] = set()


def host_has(package: str) -> bool:
    """Whether `package` (pandas, matplotlib, PIL) is importable here."""
    return importlib.util.find_spec(package) is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _dpi(d: int) -> int:
    return max(25, int(d * _DPI_SCALE))


def _render_anyway(path) -> bool:
    p = Path(path)
    key = f"{p.parent.name}/{p.name}"
    pattern = re.sub(r"\d+", "N", key)
    if pattern not in _RENDERED_PATTERNS:
        _RENDERED_PATTERNS.add(pattern)
        return True
    return zlib.crc32(key.encode()) % 8 == 0


def _savefig(fig, path, dpi: int, **kw) -> None:
    """The one savefig of every figure writer here."""
    global _STUB_PNG
    if _FAST_FIGURES and not _render_anyway(path):
        if _STUB_PNG is None:
            import io

            from PIL import Image

            buf = io.BytesIO()
            Image.new("L", (1, 1), 128).save(buf, format="PNG")
            _STUB_PNG = buf.getvalue()
        Path(path).write_bytes(_STUB_PNG)
        return
    fig.savefig(path, dpi=_dpi(dpi), format="png", **kw)


def plot_convergence(g_best_series, out_path, title="PSO convergence"):
    """Global-best trajectory (reference util_report.py:23-29)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(np.asarray(g_best_series))
    ax.set_xlabel("iteration")
    ax.set_ylabel("global best fitness")
    ax.set_title(title)
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_particle_dimensions(trajectories, out_dir, prefix="dim"):
    """Per-latent-dimension particle scatter over iterations
    (reference util_report.py:36-73). trajectories: [iters+1, N, d]."""
    plt = _plt()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tr = np.asarray(trajectories)
    iters, n, d = tr.shape
    paths = []
    for dim in range(d):
        fig, ax = plt.subplots()
        for p in range(n):
            ax.plot(np.arange(iters), tr[:, p, dim], alpha=0.4, lw=0.8)
        ax.set_xlabel("iteration")
        ax.set_ylabel(f"position dim {dim}")
        path = out_dir / f"{prefix}_{dim}.png"
        _savefig(fig, path, 150)
        plt.close(fig)
        paths.append(path)
    return paths


def plot_fitness_landscape_2d(
    fitness_fn, center, out_path, positions=None, span=3.0, resolution=100
):
    """2-D fitness contour around `center` with particles overlaid
    (reference plot2d, util_report.py:82-141): one fitness_fn call on the
    whole [res², 2] mesh."""
    plt = _plt()
    center = np.asarray(center)
    xs = np.linspace(center[0] - span, center[0] + span, resolution)
    ys = np.linspace(center[1] - span, center[1] + span, resolution)
    gx, gy = np.meshgrid(xs, ys)
    mesh = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)
    vals = np.asarray(fitness_fn(mesh)).reshape(resolution, resolution)

    fig, ax = plt.subplots()
    cs = ax.contourf(gx, gy, vals, levels=30, cmap="viridis")
    fig.colorbar(cs, ax=ax, label="fitness")
    if positions is not None:
        positions = np.asarray(positions)
        ax.scatter(positions[:, 0], positions[:, 1], c="red", s=8, label="particles")
        ax.legend()
    ax.scatter([center[0]], [center[1]], marker="*", c="white", s=120)
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def make_gif(frame_paths, out_path, duration_ms: int = 200):
    """Frames → GIF (reference util_report.py:75-79). Frames are read and
    closed up front: hundreds of open PIL handles would exhaust the fd
    limit."""
    from PIL import Image

    frames = []
    for p in frame_paths:
        with Image.open(p) as im:
            frames.append(im.copy())
    if not frames:
        raise ValueError("no frames")
    frames[0].save(
        out_path, save_all=True, append_images=frames[1:], duration=duration_ms, loop=0
    )
    return Path(out_path)


def plot_mean_mse(series, out_path):
    """Mean pairwise-distance trajectory, the `mean_mse` branch of the
    reference's plot_training (util_report.py:219-227)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot(np.asarray(series), label="mean_mse", color="r")
    ax.set_title("mse between particles position")
    ax.set_xlabel("Iterations")
    ax.set_ylabel("mean_mse")
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_particles_last_iteration(final_positions, out_path):
    """Final particle position per latent dimension (reference
    plot_features_last_iteration, util_report.py:36-51)."""
    plt = _plt()
    pos = np.asarray(final_positions)  # [N, d]
    n, d = pos.shape
    fig, ax = plt.subplots(figsize=(8, 6))
    cmap = plt.get_cmap("hsv", d)
    for dim in range(d):
        ax.scatter(pos[:, dim], np.full(n, dim), s=10.0, marker="o",
                   edgecolors="none", color=cmap(dim))
    ax.xaxis.grid(True)
    ax.set_xlabel("Particles Position")
    ax.set_ylabel("Dimensions")
    ax.set_title("Particle Position for each dimension at last PSO iteration")
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def grid_canvas(images, ncols: int = 8, drange=(0, 1), padding: int = 2):
    """torchvision.utils.make_grid-equivalent canvas: [N, C, H, W] →
    [C, H', W'] float in [0, 1], black padding between cells."""
    imgs = np.asarray(images, np.float32)
    lo, hi = drange
    imgs = np.clip((imgs - lo) / (hi - lo), 0.0, 1.0)
    n, c, h, w = imgs.shape
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    canvas = np.zeros(
        (c, nrows * (h + padding) + padding, ncols * (w + padding) + padding),
        np.float32,
    )
    for i in range(n):
        r, cc = divmod(i, ncols)
        y = r * (h + padding) + padding
        x = cc * (w + padding) + padding
        canvas[:, y : y + h, x : x + w] = imgs[i]
    return canvas


def save_image_grid(images, out_path, ncols: int = 8, drange=(0, 1), padding: int = 2):
    """Grid PNG writer (PIL, no matplotlib) for the per-iteration
    `pso_images_{i}.png` grids (reference src/pso/util_pso.py:127-133).
    images: [N, C, H, W]."""
    from PIL import Image

    canvas = grid_canvas(images, ncols=ncols, drange=drange, padding=padding)
    arr = (canvas * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
    img = Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
    img.save(out_path, format="PNG")
    return Path(out_path)


def _round_half_up(number: float) -> int:
    """The reference's grid-side rule (util_data.py:312-314):
    int(ceil(x + 0.5)), so sqrt(16) gives side 5 and sqrt(64) side 9."""
    return int(math.ceil(number + 0.5))


def superimage(images, out_path, drange=(-1, 1), side=None, cap=None):
    """The reference's `synthetic_images_{epoch}.png` superimage
    (show_gan_images, util_report_inverter.py:100-131): the first `cap`
    images, side = round_half_up(sqrt(N)), blank slots filled with zero
    images in the model's drange, tiles with no padding, raw pixels."""
    from PIL import Image

    imgs = np.asarray(images, np.float32)
    if cap is not None:
        imgs = imgs[:cap]
    n = imgs.shape[0]
    if side is None:
        side = _round_half_up(np.sqrt(n))
    if n < side * side:
        blanks = np.zeros((side * side - n, *imgs.shape[1:]), np.float32)
        imgs = np.concatenate([imgs, blanks], axis=0)
    canvas = grid_canvas(imgs, ncols=side, drange=drange, padding=0)
    arr = (canvas * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
    img = Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
    img.save(out_path, format="PNG")
    return Path(out_path)


def plot_digits(ds, out_path, n: int = 5, seed: int = 42):
    """5x5 seeded sample of labelled digits (reference util_mnist.py:6-17),
    written on a run's first train-split load."""
    imgs = ds.images.cpu().numpy()
    labels = ds.labels.cpu().numpy()
    if len(imgs) == 0:
        return None
    plt = _plt()
    idx = np.random.RandomState(seed).randint(0, len(imgs), size=n * n)
    fig, axs = plt.subplots(n, n, figsize=(8, 8))
    for ax, i in zip(axs.flatten(), idx):
        ax.imshow(imgs[i].squeeze(), cmap="gist_gray")
        ax.set_title("Label: %d" % int(labels[i]))
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_cnn_training(history: dict, out_dir, label=None):
    """One train/val figure per metric (reference plot_training,
    util_report.py:143-225), with the reference's file names, suffixed
    `_{label}` for a one-vs-all assessor."""
    plt = _plt()
    out_dir = Path(out_dir)
    suffix = f"_{label}" if label is not None else ""
    paths = []
    for tk, vk, title, fname in (
        ("train_loss", "val_loss", "Training and validation loss", "train_val_loss"),
        ("train_acc", "val_acc", "Training and Validation Accuracy", "train_val_acc"),
        ("train_f1", "val_f1", "Training and Validation F1-score", "train_val_f1-score"),
        ("train_prec", "val_prec", "Training and Validation Precision", "train_val_precision"),
        ("train_rec", "val_rec", "Training and Validation Recall", "train_val_recall"),
    ):
        if not (history.get(tk) and history.get(vk)):
            continue
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.plot(history[tk], label=tk, color="r")
        ax.plot(history[vk], label=vk, color="b")
        ax.set_title(title)
        ax.set_xlabel("Epochs")
        ax.legend()
        p = out_dir / f"{fname}{suffix}.png"
        _savefig(fig, p, 200)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_training_curves(history: dict, out_path, title="training"):
    """Loss curves from a dict of lists, one line per numeric series
    (reference util_report.py:143-225 / util_report_gan.py)."""
    plt = _plt()
    fig, ax = plt.subplots()
    for k, v in history.items():
        v = [x for x in v if x is not None]
        if v and all(isinstance(x, (int, float, np.floating)) for x in v):
            ax.plot(v, label=k)
    ax.set_xlabel("epoch/step")
    ax.legend(fontsize=7)
    ax.set_title(title)
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_gan_training(history: dict, out_dir) -> list:
    """The GAN's training figures (reference util_report_gan.py:9-45), one
    per axis, so that per-step losses and per-epoch metrics never share an
    x-axis: `train_loss.png` (loss_gen and loss_disc against steps),
    `fid.png`, `is.png`, `rec_loss_synthetic.png` (against epochs)."""
    plt = _plt()
    out_dir = Path(out_dir)
    paths = []
    if history.get("loss_gen") and history.get("loss_disc"):
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.plot(history["loss_gen"], label="loss_gen", color="r")
        ax.plot(history["loss_disc"], label="loss_disc", color="b")
        ax.set_title("Training G and D loss")
        ax.set_xlabel("Steps")
        ax.set_ylabel("Losses")
        ax.legend()
        _savefig(fig, out_dir / "train_loss.png", 200)
        plt.close(fig)
        paths.append(out_dir / "train_loss.png")
    for key, fname, title, ylab in (
        ("fid", "fid.png", "Frechet Inception Distance", "fid"),
        ("is", "is.png", "Inception Score", "is"),
        # the reference's file name (util_report_gan.py:47), not the key
        ("rec_loss_syn", "rec_loss_synthetic.png",
         "Reconstruction Loss Synthetic Samples", "Loss"),
    ):
        series = [v for v in history.get(key, []) if v is not None]
        if series:
            fig, ax = plt.subplots(figsize=(8, 6))
            ax.plot(series, label=key, color="r")
            ax.set_title(title)
            ax.set_xlabel("epochs")
            ax.set_ylabel(ylab)
            ax.legend()
            _savefig(fig, out_dir / fname, 200)
            plt.close(fig)
            paths.append(out_dir / fname)
    return paths


def plot_posterior_histograms(stats: dict, out_dir, epoch) -> list:
    """Per-epoch histogram and density pairs of the posterior energy and
    variance (reference plot_histogram, util_gan_evaluation.py:167-192):
    `hist_{var}_{epoch}.png` and `kde_{var}_{epoch}.png`, bins of 0.1
    (energy) and 0.01 (variance); seaborn's histplot(kde=True) is a density
    histogram and scipy's gaussian_kde here."""
    from scipy.stats import gaussian_kde

    plt = _plt()
    out_dir = Path(out_dir)
    paths = []
    widths = {"energy": 0.1, "variance": 0.01}
    for var, values in stats.items():
        v = np.asarray(values, np.float64).ravel()
        bins = max(1, int((abs(v.min()) + abs(v.max())) / widths.get(var, 0.1)))
        fig, ax = plt.subplots()
        ax.hist(v, bins=bins, color="blue")
        ax.set_ylabel("Occurrence")
        ax.set_xlabel(var)
        p = out_dir / f"hist_{var}_{epoch}.png"
        _savefig(fig, p, 200)
        plt.close(fig)
        paths.append(p)
        fig, ax = plt.subplots()
        ax.hist(v, bins=bins, density=True, color="darkblue")
        if len(v) > 1 and v.std() > 0:
            xs = np.linspace(v.min(), v.max(), 200)
            ax.plot(xs, gaussian_kde(v)(xs), lw=3)
        ax.set_xlabel("Variance")  # the reference labels both plots so
        p = out_dir / f"kde_{var}_{epoch}.png"
        _savefig(fig, p, 200)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_posterior_polarization(p_yx, class_names, out_path):
    """The mean posterior of each classifier over the samples, sorted
    (reference util_gan_evaluation.py:139-155)."""
    plt = _plt()
    mean = np.asarray(p_yx).mean(axis=0)
    order = np.argsort(mean)
    fig, ax = plt.subplots()
    ax.plot(np.arange(len(order)), mean[order])
    ax.set_xticks(np.arange(len(order)))
    ax.set_xticklabels([str(class_names[i]) for i in order])
    ax.set_xlabel("Classifier/Class")
    ax.set_ylabel("Medium activation across samples")
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_vqvae_losses(history: dict, out_dir) -> list:
    """The VQ-VAE's component figures (reference utils_vq_vae/
    util_report.py:13-36): train against val-OoD reconstruction loss →
    `reconstruction_loss.png`, the vq loss → `vq_loss.png`, each only where
    both its series exist."""
    plt = _plt()
    out_dir = Path(out_dir)
    paths = []
    for pair, fname, title in (
        (("train_loss_recons", "val_ood_loss_recons"), "reconstruction_loss.png",
         "Reconstruction Loss"),
        (("train_loss_vq", "val_ood_loss_vq"), "vq_loss.png", "vq loss"),
    ):
        if not all(history.get(k) for k in pair):
            continue
        fig, ax = plt.subplots(figsize=(8, 6))
        for k, color in zip(pair, ("r", "b")):
            ax.plot(np.asarray(history[k], np.float64), label=k, color=color)
        ax.set_title(title)
        ax.set_xlabel("Epochs")
        ax.set_ylabel("Losses")
        ax.legend()
        _savefig(fig, out_dir / fname, 200)
        plt.close(fig)
        paths.append(out_dir / fname)
    return paths


def save_grayscale(out_path, image):
    """A 2-D uint8 image → PNG (PIL), the reference's cv2 `save_image`
    (util_report_inverter.py:87-98)."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D grayscale image, got {arr.shape}")
    Image.fromarray(arr.astype(np.uint8), mode="L").save(out_path)
    return Path(out_path)


def plot_regularize_inverter_losses(history: dict, out_path):
    """loss_pix / loss_reg / loss of a gradient inversion on one figure
    (reference util_report_inverter.py:76-84)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    for c, color in zip(("loss_pix", "loss_reg", "loss"), ("r", "b", "g")):
        if history.get(c) is not None:
            ax.plot(np.asarray(history[c]), label=c, color=color)
    ax.set_title("Optimization losses")
    ax.set_xlabel("Iterations")
    ax.set_ylabel("Losses")
    ax.legend()
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_phase_losses(history: dict, out_dir, phase: str):
    """The adversarial inverter's `{phase}_G_losses.png` (encoder total,
    adv, rec_pix, rec_fea) and `{phase}_D_losses.png` (discriminator total,
    adv, R1) (reference util_report_inverter.py:41-74); a figure with fewer
    than two of its series in `history` is skipped."""
    plt = _plt()
    out_dir = Path(out_dir)
    paths = []
    for name, keys, colors in (
        ("G_losses", (f"{phase}_loss_enc", f"{phase}_loss_enc_adv",
                      f"{phase}_loss_enc_rec_pix", f"{phase}_loss_enc_rec_fea"),
         ("r", "b", "g", "m")),
        ("D_losses", (f"{phase}_loss_disc", f"{phase}_loss_disc_adv",
                      f"{phase}_loss_disc_r1penalty"), ("r", "b", "g")),
    ):
        present = [(k, c) for k, c in zip(keys, colors) if history.get(k)]
        if len(present) < 2:
            continue
        fig, ax = plt.subplots(figsize=(8, 6))
        for k, c in present:
            ax.plot(history[k], label=k, color=c)
        ax.set_title(f"{phase} {'G' if name == 'G_losses' else 'D'} losses")
        ax.set_xlabel("Epochs")
        ax.set_ylabel("Losses")
        ax.legend()
        p = out_dir / f"{phase}_{name}.png"
        _savefig(fig, p, 200)
        plt.close(fig)
        paths.append(p)
    return paths


def recon_panel(originals, reconstructions, out_path, n_img: int = 10):
    """Originals over their reconstructions, a 2 x n panel (reference
    show_images, utils_vq_vae/util_report.py:91-115)."""
    plt = _plt()
    originals = np.asarray(originals)[:n_img]
    reconstructions = np.asarray(reconstructions)[:n_img]
    n = len(originals)
    fig = plt.figure(figsize=(9, 2))
    for i in range(n):
        for row, imgs, title in ((0, originals, "Original images"),
                                 (1, reconstructions, "Reconstructed images")):
            ax = fig.add_subplot(2, n, row * n + i + 1)
            ax.imshow(imgs[i].squeeze(), cmap="gist_gray")
            ax.get_xaxis().set_visible(False)
            ax.get_yaxis().set_visible(False)
            if i == n // 2:
                ax.set_title(title)
    _savefig(fig, out_path, 400)
    plt.close(fig)
    return Path(out_path)


def denoise_panel(originals, noisy, reconstructions, out_path, n_img: int = 10):
    """Original / noisy / denoised, a 3 x n panel (reference
    `plot_den_ae_outputs`, evaluation/util_cae.py:284-310, `img_loss.png`)."""
    plt = _plt()
    rows = [np.asarray(r)[:n_img] for r in (originals, noisy, reconstructions)]
    n = len(rows[0])
    fig = plt.figure(figsize=(9, 3))
    for r, row in enumerate(rows):
        for i in range(n):
            ax = fig.add_subplot(3, n, r * n + i + 1)
            ax.imshow(row[i].squeeze(), cmap="gist_gray")
            ax.get_xaxis().set_visible(False)
            ax.get_yaxis().set_visible(False)
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_latent_space(embeddings, labels, out_dir, dataset="Training"):
    """The CAE's 2-D latent scatter, one colour per label (reference
    `plot_feature_latent_space`, util_cae.py:375-409) →
    `latent_space_{dataset}.png`."""
    plt = _plt()
    embeddings, labels = np.asarray(embeddings), np.asarray(labels)
    fig, ax = plt.subplots()
    for lab in np.unique(labels):
        m = labels == lab
        ax.scatter(embeddings[m, 0], embeddings[m, 1], label=str(lab), alpha=1, s=10,
                   marker="o", edgecolors="none")
    ax.legend()
    ax.set_xlabel("var_0")
    ax.set_ylabel("var_1")
    ax.set_title(f"Latent space {dataset} Set")
    out_path = Path(out_dir) / f"latent_space_{dataset}.png"
    _savefig(fig, out_path, 400)
    plt.close(fig)
    return out_path


def plot_img_latent_space(decode_batch, out_dir, r0=(-1, 1), r1=(-1, 1), n=10, w=28):
    """The decoder swept over the 2-D latent box (reference
    `plot_img_latent_space`, util_cae.py:355-374): an n x n canvas whose
    rows span r1 bottom-up and columns r0 left to right, all n² latents
    decoded as one batch. decode_batch: z [B, 2] (float32 numpy) → images
    [B, ...] reshapeable to (w, w)."""
    plt = _plt()
    xs, ys = np.linspace(*r0, n), np.linspace(*r1, n)
    grid = np.array([[x, y] for y in ys for x in xs], np.float32)
    imgs = np.asarray(decode_batch(grid)).reshape(n, n, w, w)
    canvas = np.zeros((n * w, n * w), np.float32)
    for i in range(n):  # row i: latent y index, drawn bottom-up
        for j in range(n):
            canvas[(n - 1 - i) * w:(n - i) * w, j * w:(j + 1) * w] = imgs[i, j]
    fig, ax = plt.subplots()
    ax.imshow(canvas, extent=[*r0, *r1], cmap="gist_gray")
    out_path = Path(out_dir) / f"img_latent_r0_{r0[0]}_{r0[1]}__r1_{r1[0]}_{r1[1]}.png"
    _savefig(fig, out_path, 400)
    plt.close(fig)
    return out_path


def plot_battery_tree(activation: dict, classes, out_path):
    """The battery's activation curves (reference classifiers.py:219-239,
    cnn.py:211-246): per class's test set, the count of positive
    predictions of every battery member."""
    plt = _plt()
    fig, ax = plt.subplots()
    for label, counts in activation.items():
        ax.plot(counts, label=str(label))
    ax.legend()
    ax.set_xticks(np.arange(len(classes)))
    ax.set_xticklabels([str(c) for c in classes])
    ax.set_xlabel("Classifiers")
    ax.set_ylabel("Classifier activation per test set")
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def error_reject_curve(y_true, y_score, out_path=None, label=None):
    """%error against %rejection of one one-vs-all battery classifier
    (reference classifiers.py:186-213): the 90-threshold sweep of
    `evaluation.error_reject_points`, drawn with marker 'o', the class as
    title and ylim [0, 30] where `out_path` is given. Returns (p_rej,
    p_err)."""
    from gan_discovery_pso_tpu_torch.evaluation.classifiers import error_reject_points

    p_rej, p_err, _ = error_reject_points(y_true, y_score)
    if out_path is not None:
        plt = _plt()
        fig, ax = plt.subplots()
        ax.plot(p_rej, p_err, marker="o")
        if label is not None:
            ax.set_title(str(label))
        ax.set_ylabel("% error")
        ax.set_xlabel("% rejection")
        ax.set_ylim([0, 30])
        _savefig(fig, out_path, 200)
        plt.close(fig)
    return p_rej, p_err


# -- the latent analyses -----------------------------------------------------


def image_grid(images, out_path, ncols: int = 8, drange=(0, 1)):
    """A superimage grid through matplotlib (reference util_report_gan.py:
    50-87). images: [N, C, H, W]."""
    plt = _plt()
    n = np.asarray(images).shape[0]
    canvas = grid_canvas(images, ncols=ncols, drange=drange, padding=0)
    c = canvas.shape[0]
    hwc = canvas.transpose(1, 2, 0)
    cols = min(ncols, n)
    fig, ax = plt.subplots(figsize=(cols, -(-n // cols)))
    ax.imshow(hwc.squeeze(-1) if c == 1 else hwc, cmap="gray" if c == 1 else None)
    ax.axis("off")
    _savefig(fig, out_path, 150, bbox_inches="tight")
    plt.close(fig)
    return Path(out_path)


def plot_scatter_2d(points, labels, out_path, title="", centers=None, extra=None):
    """A labelled 2-D latent scatter (the PCA, UMAP and cluster plots)."""
    plt = _plt()
    points, labels = np.asarray(points), np.asarray(labels)
    fig, ax = plt.subplots()
    for lab in np.unique(labels):
        m = labels == lab
        ax.scatter(points[m, 0], points[m, 1], s=6, alpha=0.6, label=str(lab))
    if centers is not None:
        centers = np.asarray(centers)
        ax.scatter(centers[:, 0], centers[:, 1], marker="x", c="black", s=80)
    if extra is not None:
        extra = np.asarray(extra)
        ax.scatter(extra[:, 0], extra[:, 1], marker="^", c="red", s=30, label="ood")
    ax.legend(fontsize=7, markerscale=2)
    ax.set_title(title)
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_pca_variance(explained_variance, out_path):
    """The cumulative explained-variance curve (reference pca_fun,
    util_latent_analysis.py:21-28), summed up to but excluding i, so the
    curve starts at 0 as the reference's does."""
    plt = _plt()
    ev = np.asarray(explained_variance, np.float64)
    frac = np.array([ev[:i].sum() for i in range(len(ev))]) / ev.sum()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot(frac, linestyle="-", linewidth=2.0)
    ax.set_xlabel("PCA component")
    ax.set_ylabel("Explained variance")
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_ellipsoids(points, assignments, means, covariances, out_path,
                    dim_red_algorithm=None):
    """Gaussian-mixture component ellipses over the clustered points
    (reference plot_ellipsoids, util_latent_analysis.py:202-243): a
    2√2·√eigval ellipse along the leading eigenvector per component."""
    import matplotlib as mpl

    plt = _plt()
    pts, asg = np.asarray(points), np.asarray(assignments)
    colors = ["navy", "c", "cornflowerblue", "gold", "darkorange", "darkviolet",
              "forestgreen", "salmon", "lightcoral", "deepskyblue"]
    fig, ax = plt.subplots(figsize=(8, 6))
    for i, (mean, covar) in enumerate(zip(np.asarray(means), np.asarray(covariances))):
        color = colors[i % len(colors)]
        if not np.any(asg == i):
            continue
        v, w = np.linalg.eigh(covar)
        v = 2.0 * np.sqrt(2.0) * np.sqrt(np.maximum(v, 0.0))
        u = w[0] / np.linalg.norm(w[0])
        ax.scatter(pts[asg == i, 0], pts[asg == i, 1], s=0.8, color=color)
        angle = 180.0 * np.arctan(u[1] / u[0]) / np.pi
        ell = mpl.patches.Ellipse(mean[:2], v[0], v[1], angle=180.0 + angle, color=color)
        ell.set_clip_box(ax.bbox)
        ell.set_alpha(0.5)
        ax.add_artist(ell)
    tag = dim_red_algorithm or ""
    ax.set_title(f"{tag} Gaussian Mixture".strip() if tag else "Latent Space")
    ax.set_xlabel(f"{tag}_1" if tag else "Z_1")
    ax.set_ylabel(f"{tag}_2" if tag else "Z_2")
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_voronoi(points, out_path, labels=None, title="Voronoi"):
    """A Voronoi diagram with its infinite regions closed (reference
    util_latent_analysis.py:66-166)."""
    from gan_discovery_pso_tpu_torch.analysis.latent import voronoi_finite_polygons

    plt = _plt()
    points = np.asarray(points)
    regions, vertices = voronoi_finite_polygons(points)
    fig, ax = plt.subplots()
    for region in regions:
        ax.fill(*zip(*vertices[region]), alpha=0.3)
    if labels is not None:
        for lab in np.unique(labels):
            m = np.asarray(labels) == lab
            ax.scatter(points[m, 0], points[m, 1], s=10, label=str(lab))
        ax.legend(fontsize=7)
    else:
        ax.scatter(points[:, 0], points[:, 1], s=10, c="black")
    pad = 0.5
    ax.set_xlim(points[:, 0].min() - pad, points[:, 0].max() + pad)
    ax.set_ylim(points[:, 1].min() - pad, points[:, 1].max() + pad)
    ax.set_title(title)
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_distance_histogram(distances, out_path, title="pairwise distances", bins: int = 50):
    """A distance histogram (reference src/training/pso_analysis_distance.py:169-228)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.hist(np.asarray(distances), bins=bins, color="steelblue", alpha=0.8)
    ax.set_xlabel("euclidean distance")
    ax.set_ylabel("count")
    ax.set_title(title)
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_sorted_distance_curves(series: dict, out_path):
    """Sorted distance curves, one per entry (reference
    pso_analysis_distance.py:169-228 fig1 → paiwise_mse.png, the reference's
    spelling)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    for name, values in series.items():
        ax.plot(np.sort(np.asarray(values).ravel()), label=str(name))
    ax.set_xlabel("pair index")
    ax.set_ylabel("mse value")
    ax.legend()
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def plot_distance_kde(series: dict, out_path):
    """The distance distributions as histograms with scipy's gaussian_kde
    (reference fig2 → latent_kde_distribution.png, drawn there with
    seaborn)."""
    from scipy.stats import gaussian_kde

    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    for name, values in series.items():
        v = np.asarray(values, np.float64).ravel()
        ax.hist(v, bins=30, density=True, alpha=0.3)
        if len(v) > 1 and v.std() > 0:
            xs = np.linspace(v.min(), v.max(), 200)
            ax.plot(xs, gaussian_kde(v)(xs), label=str(name))
    ax.set_xlabel("mse value")
    ax.set_ylabel("counts")
    if ax.get_legend_handles_labels()[1]:
        ax.legend()
    _savefig(fig, out_path, 200)
    plt.close(fig)
    return Path(out_path)


def roc_curve(y_true, y_score):
    """sklearn's `roc_curve(y_true, y_score)` with drop_intermediate=True:
    (fpr, tpr, thresholds); the scores sorted stably in descending order,
    one point per distinct score, collinear points dropped, (0, 0) first.
    A class absent from y_true gives NaN rates, as in sklearn."""
    y = np.asarray(y_true).ravel() == 1
    s = np.asarray(y_score).ravel()
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order].astype(np.float64)
    thr = np.r_[np.nonzero(np.diff(s))[0], len(y) - 1]
    tps = np.cumsum(y)[thr]
    fps = 1 + thr.astype(np.float64) - tps
    thresholds = s[thr].astype(np.float64)
    if len(fps) > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """The trapezoidal area under (x, y), x monotonic (sklearn's `auc`)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    dx = np.diff(x)
    direction = -1 if np.any(dx < 0) and np.all(dx <= 0) else 1
    if np.any(dx < 0) and direction == 1:
        raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * np.trapezoid(y, x))


def roc_auc_score(y_true, y_score) -> float:
    """sklearn's binary `roc_auc_score`: NaN where y_true holds one class."""
    if len(np.unique(np.asarray(y_true))) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def confusion_counts(y_true, y_pred) -> tuple[int, int, int, int]:
    """(tn, fp, fn, tp) of binary labels (sklearn's `confusion_matrix(...,
    labels=[0, 1]).ravel()`)."""
    y, p = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    return (int(((y == 0) & (p == 0)).sum()), int(((y == 0) & (p == 1)).sum()),
            int(((y == 1) & (p == 0)).sum()), int(((y == 1) & (p == 1)).sum()))


class CvEvaluator:
    """ROC and metric aggregation across CV folds (the reference's `Eval`
    class, util_report.py:303-466): per-fold scores and labels, the mean ROC
    with its std band, the summary metrics. sklearn's metrics are computed
    here in numpy (`roc_curve`, `auc`, `roc_auc_score`, `confusion_counts`),
    since the card's host has no sklearn."""

    # the reference's per-fold metrics (compute_metrics, util_report.py:303-323,
    # selected_keys :327) and the ratios its MEAN/STD rows aggregate (:413-422)
    METRIC_KEYS = ("accuracy", "precision", "recall", "f1", "auc", "specificity", "g",
                   "tn", "tp", "fp", "fn", "total_neg", "total_pos")
    RATIO_KEYS = ("accuracy", "precision", "recall", "f1", "auc", "specificity", "g")

    def __init__(self):
        self.fold_scores: list[np.ndarray] = []
        self.fold_labels: list[np.ndarray] = []

    def add_fold(self, y_true, y_score):
        self.fold_labels.append(np.asarray(y_true))
        self.fold_scores.append(np.asarray(y_score))

    def summary(self) -> dict:
        """Mean and std of the AUC over folds with both classes, the mean
        accuracy and binary F1 (0 where undefined) at threshold 0.5."""
        aucs, accs, f1s = [], [], []
        for y, s in zip(self.fold_labels, self.fold_scores):
            if len(np.unique(y)) > 1:
                aucs.append(roc_auc_score(y, s))
            preds = (s >= 0.5).astype(int)
            accs.append(float(np.mean(np.asarray(y) == preds)))
            _tn, fp, fn, tp = confusion_counts(y, preds)
            f1s.append(2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0)
        return {
            "auc_mean": float(np.mean(aucs)) if aucs else float("nan"),
            "auc_std": float(np.std(aucs)) if aucs else float("nan"),
            "acc_mean": float(np.mean(accs)), "f1_mean": float(np.mean(f1s)),
        }

    def fold_metrics(self) -> list[dict]:
        """One reference score dict per fold; undefined ratios are NaN."""
        rows = []
        for y, s in zip(self.fold_labels, self.fold_scores):
            tn, fp, fn, tp = confusion_counts(y, (np.asarray(s) >= 0.5).astype(int))
            rec = tp / (tp + fn) if (tp + fn) else float("nan")
            prec = tp / (tp + fp) if (tp + fp) else float("nan")
            spec = tn / (tn + fp) if (tn + fp) else float("nan")
            f1 = (2 * rec * prec / (rec + prec)) if (rec + prec) else float("nan")
            rows.append({
                "accuracy": (tp + tn) / max(tp + tn + fp + fn, 1),
                "precision": prec, "recall": rec, "f1": f1, "auc": roc_auc_score(y, s),
                "specificity": spec, "g": math.sqrt(max(rec * spec, 0.0)),
                "tn": tn, "tp": tp, "fp": fp, "fn": fn,
                "total_neg": tn + fp, "total_pos": tp + fn,
            })
        return rows

    def write_results_xlsx(self, path, group: str = "slices"):
        """results.xlsx: one row per fold, then MEAN and STD rows over the
        ratio keys (reference write_to_excel, util_report.py:275-289,
        385, 420-422; NaN folds propagate as in its np.mean), through the
        port's `data/xlsx.py`."""
        from gan_discovery_pso_tpu_torch.data.xlsx import write_xlsx

        rows = self.fold_metrics()
        cols: dict = {"fold": [*range(len(rows)), "MEAN", "STD"],
                      "group": [group] * (len(rows) + 2)}
        for k in self.METRIC_KEYS:
            vals = [float(r[k]) for r in rows]
            if k in self.RATIO_KEYS:
                cols[k] = vals + [float(np.mean(vals)) if vals else float("nan"),
                                  float(np.std(vals)) if vals else float("nan")]
            else:
                cols[k] = vals + [None, None]
        return write_xlsx(path, cols)

    def plot_mean_roc(self, out_path, group: str = "slices"):
        """The cross-fold mean ROC with std error bars (reference
        `mean_plot_roc`, util_report.py:440-466) → `mean_roc_{group}.png`;
        None where no fold holds both classes."""
        x = np.linspace(0, 1, 100)
        tprs, fprs, aucs = [], [], []
        for y, s in zip(self.fold_labels, self.fold_scores):
            if len(np.unique(y)) < 2:
                continue
            fpr, tpr, _ = roc_curve(y, s)
            t, f = np.interp(x, fpr, tpr), np.interp(x, tpr, fpr)
            t[0] = f[0] = 0.0
            tprs.append(t)
            fprs.append(f)
            aucs.append(auc(fpr, tpr))
        if not tprs:
            return None
        plt = _plt()
        mean_tpr = np.mean(tprs, axis=0)
        mean_tpr[-1] = 1.0
        fig, ax = plt.subplots()
        ax.plot([0, 1], [0, 1], linestyle="--", lw=2, color="gray", alpha=0.8)
        ax.errorbar(x, mean_tpr, yerr=np.std(tprs, axis=0), marker="s", capsize=5,
                    capthick=2, elinewidth=2, ecolor="gray", fmt="-o", color="b",
                    label=r"ROC media (AUC = %0.2f $\pm$ %0.2f)"
                          % (auc(x, mean_tpr), np.std(aucs)), lw=2, alpha=0.8)
        ax.errorbar(x, mean_tpr, xerr=np.std(fprs, axis=0), marker="s", elinewidth=0.8,
                    ecolor="gray", fmt="-o", color="b", lw=2, alpha=0.8)
        ax.set_xlim([-0.05, 1.05])
        ax.set_ylim([-0.05, 1.05])
        ax.set_title(f"{group} mean roc curve", fontsize=14)
        ax.set_xlabel("FP Rate", fontsize=14)
        ax.set_ylabel("TP Rate", fontsize=14)
        ax.legend(loc="lower right", fontsize=12)
        _savefig(fig, out_path, 200)
        plt.close(fig)
        return Path(out_path)

    def save_overall_scores(self, out_path):
        """`overall_scores.pkl` (reference on_experiments_end,
        util_report.py:409-411): [slices_scores, patients_scores]; this
        evaluator tracks one group, so the second is empty."""
        import pickle

        with open(out_path, "wb") as f:
            pickle.dump([self.fold_metrics(), []], f)
        return Path(out_path)

    def plot_roc(self, out_path, title="ROC (CV)"):
        plt = _plt()
        mean_fpr = np.linspace(0, 1, 100)
        tprs = []
        fig, ax = plt.subplots()
        for i, (y, s) in enumerate(zip(self.fold_labels, self.fold_scores)):
            fpr, tpr, _ = roc_curve(y, s)
            ax.plot(fpr, tpr, alpha=0.3, lw=1, label=f"fold {i}")
            tprs.append(np.interp(mean_fpr, fpr, tpr))
        mean_tpr, std_tpr = np.mean(tprs, axis=0), np.std(tprs, axis=0)
        ax.plot(mean_fpr, mean_tpr, "b-", lw=2, label="mean")
        ax.fill_between(mean_fpr, mean_tpr - std_tpr, mean_tpr + std_tpr, alpha=0.2)
        ax.plot([0, 1], [0, 1], "k--", lw=1)
        ax.set_xlabel("FPR")
        ax.set_ylabel("TPR")
        ax.legend(fontsize=7)
        ax.set_title(title)
        _savefig(fig, out_path, 200)
        plt.close(fig)
        return Path(out_path)
