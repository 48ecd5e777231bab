"""The latent-analysis stages and the CLARO export (counterpart of
`gan_discovery_pso_tpu/pipelines/analysis_stages.py`: `_stack_classes` :37,
`run_pso_analysis` :68, `run_pso_analysis_clustering` :134,
`run_pso_inverter_analysis` :263, `run_pso_analysis_distance` :350,
`run_claro_preprocess` :389), after reference src/training/pso_analysis*.py,
pso_inverter_analysis.py and src/data/dataset_preparation.py.

They read the particle artifacts of the discovery, inverter and extractor
stages (`pso/io.py`) and run their PCA, UMAP, clustering and distances on
the stage's device (`analysis/latent.py`). The plots need matplotlib (and
the GIF PIL): where a package is missing, one line says what is not
written, and every computation still runs, the per-iteration projections
of `run_pso_analysis` included. `models/{algorithm}.pkl` pickles the
port's model (`analysis/cluster.py`), not an sklearn object.
"""

from __future__ import annotations

import json
import pickle
import time
from pathlib import Path

import numpy as np

from gan_discovery_pso_tpu_torch.analysis import reporting
from gan_discovery_pso_tpu_torch.analysis.latent import (
    assign_to_clusters,
    cluster_latents,
    make_umap,
    mutual_distance,
    pairwise_distances,
    pca_project,
    umap_project,
)
from gan_discovery_pso_tpu_torch.core.config import cfg_default
from gan_discovery_pso_tpu_torch.data.medical import (
    ClipSpec,
    prepare_patient_dataset,
    read_box_manifest,
    read_patients_info,
)
from gan_discovery_pso_tpu_torch.pipelines.context import StageContext
from gan_discovery_pso_tpu_torch.pipelines.stages import _can_write
from gan_discovery_pso_tpu_torch.pso.io import (
    load_final_particle_positions,
    load_particle_trajectories,
)

PLOTS = "matplotlib"


def _seed(ctx) -> int:
    return int(cfg_default(ctx.cfg, "seed", 42))


def _stack_classes(interim_dirs, classes, kind="iid"):
    """Every class's final positions stacked: ([sum_N, d], labels).
    `interim_dirs` is one dir or a sequence searched in order (the
    reference's pso_inverter runs are per patient, start_pso_optimize.sh:
    3-16, so an OoD overlay across patients spans several run dirs)."""
    if isinstance(interim_dirs, (str, Path)):
        interim_dirs = [interim_dirs]
    mats, labels = [], []
    for c in classes:
        errs = []
        for d in interim_dirs:
            try:
                m = load_final_particle_positions(d, c, kind)
                break
            except FileNotFoundError as e:
                errs.append(e)
        else:
            raise FileNotFoundError(
                f"no {kind} particle artifact for class {c} in any of "
                f"{[str(d) for d in interim_dirs]} — for OoD overlays, pass "
                "one --path-ood-pso per inverted patient") from errs[-1]
        mats.append(m)
        labels.append(np.full(len(m), c))
    return np.concatenate(mats, 0), np.concatenate(labels, 0)


def run_pso_analysis(ctx: StageContext, pso_interim_dir):
    """Per-iteration PCA and UMAP of the cross-class swarm of the config's
    IiD classes (reference pso_analysis.py:92-124): at every recorded
    iteration, every class's positions stacked (a swarm that stopped early
    gives its last row, :104-110), a full PCA and a UMAP of them →
    `training_plot/pca_space_{i}.png`, `pca_variance_plot_{i}.png`,
    `umap_space_{i}.png` and `pca_space.gif`; then the final iteration's
    `pca_iid.png` and `umap_iid.png`. Returns {"pca", "umap", "labels"} of
    the final positions (also the overall history)."""
    classes = ctx.data_cfg.iid_classes
    tag = "[pso_analysis]"
    can = _can_write(tag, ((PLOTS, "plots (training_plot/*.png, pca_*.png, umap_*.png)"),
                           ("PIL", "training_plot/pca_space.gif")))
    plot_dir = ctx.run.reports_dir / "training_plot"
    plot_dir.mkdir(parents=True, exist_ok=True)
    dev = ctx.device
    trajs = {c: load_particle_trajectories(pso_interim_dir, c) for c in classes}
    n_iters = max(t.shape[0] for t in trajs.values())

    frames, seconds = [], {"pca": 0.0, "umap": 0.0, "plots": 0.0}
    for i in range(n_iters):
        data_i = np.concatenate([trajs[c][min(i, trajs[c].shape[0] - 1)] for c in classes], 0)
        labs_i = np.concatenate([np.full(trajs[c].shape[1], c) for c in classes], 0)
        t0 = time.perf_counter()
        p_i, pca_model = pca_project(data_i, min(data_i.shape), return_model=True, device=dev)
        t1 = time.perf_counter()
        u_i, method = umap_project(data_i, 2, device=dev)
        t2 = time.perf_counter()
        if can[PLOTS]:
            reporting.plot_pca_variance(pca_model.explained_variance_,
                                        plot_dir / f"pca_variance_plot_{i}.png")
            frames.append(reporting.plot_scatter_2d(
                p_i[:, :2], labs_i, plot_dir / f"pca_space_{i}.png",
                title="PCA projection of latent space (iid class)"))
            reporting.plot_scatter_2d(u_i, labs_i, plot_dir / f"umap_space_{i}.png",
                                      title=f"{method} projection of latent space (iid class)")
        seconds["pca"] += t1 - t0
        seconds["umap"] += t2 - t1
        seconds["plots"] += time.perf_counter() - t2
    if frames and can["PIL"]:
        reporting.make_gif(frames, plot_dir / "pca_space.gif")
    print(f"{tag} {n_iters} iterations of {data_i.shape[0]} x {data_i.shape[1]}: "
          f"pca {seconds['pca']:.6f} s, umap {seconds['umap']:.6f} s, "
          f"plots {seconds['plots']:.6f} s")

    data, labels = _stack_classes(pso_interim_dir, classes)
    p2 = pca_project(data, 2, device=dev)
    u2, method = umap_project(data, 2, device=dev)
    if can[PLOTS]:
        reporting.plot_scatter_2d(p2, labels, ctx.run.reports_dir / "pca_iid.png",
                                  title="PCA of iid particles")
        reporting.plot_scatter_2d(u2, labels, ctx.run.reports_dir / "umap_iid.png",
                                  title=f"{method} of iid particles")
    ctx.run.write_timing({})  # (reference pso_analysis.py:127-132)
    summary = {"pca": p2, "umap": u2, "labels": labels}
    ctx.run.write_overall_history(summary)
    return summary


def _save_model(ctx: StageContext, algorithm: str, model) -> None:
    """`models/{algorithm}.pkl`: the port's fitted model (reference
    pso_analysis_clustering.py:181-182 pickles sklearn's)."""
    with open(ctx.run.models_dir / f"{algorithm}.pkl", "wb") as f:
        pickle.dump(model, f)


def run_pso_analysis_clustering(ctx: StageContext, pso_interim_dir, ood_interim_dir=None,
                                ood_labels=None):
    """Cluster the config's IiD classes' particles with its
    `trainer_pso_analysis.clustering_algorithm`, and overlay and assign the
    OoD latents of `ood_labels` (reference pso_analysis_clustering.py:
    174-228):
    - `models/{algorithm}.pkl`, the full-dimensional model (:181-182);
    - at dim_space 2: `training_plot/latent_space.png` (:183), and
      `ellipsoid_Gaussian Mixture.png` for `em` (:184);
    - for each of PCA and UMAP, the clustering refitted on the 2-D data
      (:186-193) → `latent_space_{alg}.png` (+ `ellipsoid_{alg}.png` for em);
    - per overlay label: `latent_space_ood_{label}.png` at dim 2 and
      `latent_space_{alg}_ood_{label}.png` (the reducer's transform of at
      most 1000 overlay latents);
    - `clusters.png`, `voronoi.png`, `clusters_with_ood.png` and
      `ood_cluster_assignment.json` (per label, every particle's cluster
      and the counts).
    Returns {"cluster_labels", "centers"} (+ "ood_assignment")."""
    classes = ctx.data_cfg.iid_classes
    algorithm = str(ctx.cfg.trainer_pso_analysis.clustering_algorithm)
    can = _can_write("[pso_analysis_clustering]", (
        (PLOTS, "plots (training_plot/*.png, clusters*.png, voronoi.png)"),))
    draw = can[PLOTS]
    seed, dev = _seed(ctx), ctx.device
    plot_dir = ctx.run.reports_dir / "training_plot"
    plot_dir.mkdir(parents=True, exist_ok=True)

    data, labels = _stack_classes(pso_interim_dir, classes)
    data = data.astype(np.float64)
    cl_labels, centers, model = cluster_latents(data, algorithm, len(classes), seed=seed,
                                                device=dev)
    _save_model(ctx, algorithm, model)
    if data.shape[1] == 2 and draw:
        reporting.plot_scatter_2d(data, labels, plot_dir / "latent_space.png",
                                  title="Latent Space")
        if algorithm == "em":
            reporting.plot_ellipsoids(data, model.predict(data), model.means_,
                                      model.covariances_,
                                      plot_dir / "ellipsoid_Gaussian Mixture.png",
                                      dim_red_algorithm="Gaussian Mixture")

    ood_data = ood_lab = None
    if ood_interim_dir is not None and ood_labels:
        ood_data, ood_lab = _stack_classes(ood_interim_dir, ood_labels, "ood")
        ood_data = ood_data.astype(np.float64)

    for dim_red in ("pca", "umap"):
        if dim_red == "pca":
            reduced, reducer = pca_project(data, 2, return_model=True, device=dev)
        else:
            reducer, _ = make_umap(2, random_state=seed, device=dev)
            reduced = reducer.fit_transform(data)
        _red_labels, _centers, red_model = cluster_latents(reduced, algorithm, len(classes),
                                                           seed=seed, device=dev)
        overlays = {}  # label → (at most 1000 overlay latents, their reduced form)
        for label in (ood_labels if ood_data is not None else ()):
            sel = ood_data[ood_lab == label][:1000]
            overlays[label] = (sel, reducer.transform(sel))
        if not draw:
            continue
        reporting.plot_scatter_2d(reduced, labels, plot_dir / f"latent_space_{dim_red}.png",
                                  title=f"{dim_red} Latent Space")
        if algorithm == "em":
            reporting.plot_ellipsoids(reduced, red_model.predict(reduced), red_model.means_,
                                      red_model.covariances_,
                                      plot_dir / f"ellipsoid_{dim_red}.png",
                                      dim_red_algorithm=dim_red)
        for label, (sel, sel_reduced) in overlays.items():
            if dim_red == "pca" and data.shape[1] == 2:
                reporting.plot_scatter_2d(data, labels,
                                          plot_dir / f"latent_space_ood_{label}.png",
                                          title="Latent Space", extra=sel)
            reporting.plot_scatter_2d(reduced, labels,
                                      plot_dir / f"latent_space_{dim_red}_ood_{label}.png",
                                      title=f"{dim_red} Latent Space", extra=sel_reduced)

    p2 = pca_project(np.vstack([data, centers]), 2, device=dev)
    if draw:
        reporting.plot_scatter_2d(p2[:len(data)], cl_labels,
                                  ctx.run.reports_dir / "clusters.png",
                                  title=f"{algorithm} clusters", centers=p2[len(data):])
        if data.shape[1] == 2 and len(centers) >= 4:  # Qhull needs ≥ d+2 points
            reporting.plot_voronoi(centers, ctx.run.reports_dir / "voronoi.png",
                                   title="cluster Voronoi")

    result = {"cluster_labels": cl_labels, "centers": centers}
    if ood_data is not None:
        assignment = assign_to_clusters(model, ood_data)
        result["ood_assignment"] = assignment
        p_all = pca_project(np.vstack([data, ood_data]), 2, device=dev)
        if draw:
            reporting.plot_scatter_2d(p_all[:len(data)], cl_labels,
                                      ctx.run.reports_dir / "clusters_with_ood.png",
                                      title="clusters + OoD", extra=p_all[len(data):])
        by_label: dict = {}
        for lab, a in zip(ood_lab, assignment):
            by_label.setdefault(str(lab), []).append(int(a))
        with open(ctx.run.reports_dir / "ood_cluster_assignment.json", "w") as f:
            json.dump({lab: {"assignment": asg,
                             "counts": {str(c): asg.count(c) for c in sorted(set(asg))}}
                       for lab, asg in by_label.items()}, f, indent=2)
    return result


def run_pso_inverter_analysis(ctx: StageContext, iid_interim_dir, ood_interim_dir, ood_patient):
    """One OoD patient's latents assigned to the discovered clusters
    (reference src/training/pso_inverter_analysis.py:180-210):
    - the config's clustering fitted on the full-dimensional particles of
      its IiD classes and saved (`{algorithm}.pkl`, :186-188);
    - the cluster of every latent of the patient (:205-207) →
      `ood_patient_{p}_cluster_assignment.json` with the counts;
    - for each of PCA and UMAP, the IiD latent space and the patient's
      latents through the reducer's transform (:194-208; the reference's
      refit of the clustering on the reduced data only fed an em plot, so
      it is not made)."""
    classes = ctx.data_cfg.iid_classes
    algorithm = str(ctx.cfg.trainer_pso_analysis.clustering_algorithm)
    can = _can_write("[pso_inverter_analysis]", ((PLOTS, "plots (training_plot/*.png)"),))
    seed, dev = _seed(ctx), ctx.device
    plot_dir = ctx.run.reports_dir / "training_plot"
    plot_dir.mkdir(parents=True, exist_ok=True)

    data, labels = _stack_classes(iid_interim_dir, classes)
    ood_data, _ = _stack_classes(ood_interim_dir, [ood_patient], "ood")
    data, ood_data = data.astype(np.float64), ood_data.astype(np.float64)

    _cl_labels, _centers, model = cluster_latents(data, algorithm, len(classes), seed=seed,
                                                  device=dev)
    _save_model(ctx, algorithm, model)
    if data.shape[1] == 2 and algorithm == "em" and can[PLOTS]:
        reporting.plot_ellipsoids(data, model.predict(data), model.means_, model.covariances_,
                                  plot_dir / "ellipsoid_Gaussian Mixture.png",
                                  dim_red_algorithm="Gaussian Mixture")
    assignment = assign_to_clusters(model, ood_data)
    counts = {int(c): int((assignment == c).sum()) for c in np.unique(assignment)}
    report = {
        "ood_patient": int(ood_patient),
        "algorithm": algorithm,
        "n_ood_latents": int(len(ood_data)),
        "cluster_assignment": [int(a) for a in assignment],
        "cluster_counts": counts,
        "dominant_cluster": int(max(counts, key=counts.get)),
    }
    with open(ctx.run.reports_dir / f"ood_patient_{ood_patient}_cluster_assignment.json",
              "w") as f:
        json.dump(report, f, indent=2)

    for method in ("pca", "umap"):
        if method == "pca":
            reduced_iid, reducer = pca_project(data, 2, return_model=True, device=dev)
        else:
            reducer, _tag = make_umap(2, random_state=seed, device=dev)
            reduced_iid = reducer.fit_transform(data)
        reduced_ood = reducer.transform(ood_data)
        if can[PLOTS]:
            reporting.plot_scatter_2d(reduced_iid, labels,
                                      plot_dir / f"latent_space_{method}.png",
                                      title=f"{method} latent space (iid)")
            reporting.plot_scatter_2d(reduced_iid, labels,
                                      plot_dir / f"latent_space_{method}_ood_{ood_patient}.png",
                                      title=f"{method} iid + ood patient {ood_patient}",
                                      extra=reduced_ood)
    return report


def run_pso_analysis_distance(ctx: StageContext, pso_interim_dir):
    """Within-class pairwise and cross-class mutual distance distributions
    of the config's IiD classes (reference pso_analysis_distance.py:
    169-228), each class capped at 250
    latents (:191-192) → `distance_summary.json`, `pairwise_class_{c}.png`,
    `general/paiwise_mse.png` (the reference's spelling) and
    `general/latent_kde_distribution.png`."""
    classes = ctx.data_cfg.iid_classes
    can = _can_write("[pso_analysis_distance]", (
        (PLOTS, "plots (pairwise_class_*.png, general/*.png)"),))
    dev = ctx.device
    general = ctx.run.reports_dir / "general"
    general.mkdir(parents=True, exist_ok=True)
    summary, curves = {}, {}
    mats = {c: load_final_particle_positions(pso_interim_dir, c) for c in classes}
    for c in classes:
        d = pairwise_distances(mats[c][:250], device=dev)
        if can[PLOTS]:
            reporting.plot_distance_histogram(d, ctx.run.reports_dir / f"pairwise_class_{c}.png",
                                              title=f"class {c} pairwise")
        curves[str(c)] = d
        summary[f"within_{c}"] = {"mean": float(d.mean()), "std": float(d.std())}
    for i, a in enumerate(classes):
        for b in classes[i + 1:]:
            d = mutual_distance(mats[a][:250], mats[b][:250], device=dev)
            if i == 0 and b == classes[1]:
                curves["mutual"] = d  # the reference's one 'mutual' curve (:174-176)
            summary[f"between_{a}_{b}"] = {"mean": float(d.mean()), "std": float(d.std())}
    if can[PLOTS]:
        reporting.plot_sorted_distance_curves(curves, general / "paiwise_mse.png")
        reporting.plot_distance_kde(curves, general / "latent_kde_distribution.png")
    with open(ctx.run.reports_dir / "distance_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    ctx.run.write_timing({})  # (reference pso_analysis_distance.py:229-234)
    ctx.run.write_overall_history(summary)
    return summary


def run_claro_preprocess(ctx: StageContext, limit: int | None = None):
    """The CLARO CT export from the config and its manifests (reference
    src/data/dataset_preparation.py:78-103, configs/claro_preprocess.yaml):
    - `patients_info_{dataset}.xlsx` (or .csv) in the interim dir lists the
      slice TIFFs (its 'image' column);
    - `data.box_file` maps 'img ID' to the `data.box_value` box;
    - the slices are the sorted intersection of the two (np.intersect1d,
      :87), cut to `limit`;
    - each runs crop → resize (the stage's device) → clip → normalise →
      `interim/stylegan/{slice}.tif` (float32) and the stack
      `claro_preprocessed.npz`.
    Returns (stack, meta)."""
    cfg = ctx.cfg
    clip, scale = cfg.data.get("clip"), cfg.data.get("scale")
    clip = ClipSpec(float(clip["min"]), float(clip["max"])) if clip else None
    scale = ClipSpec(float(scale["min"]), float(scale["max"])) if scale else None

    box_file = cfg.data.get("box_file")
    boxes = (read_box_manifest(box_file, str(cfg.data.get("box_value", "box")))
             if box_file else None)
    dataset = ctx.data_cfg.dataset
    base = Path(ctx.data_cfg.interim_dir) / dataset
    cands = [base / f"patients_info_{dataset}.xlsx", base / f"patients_info_{dataset}.csv"]
    patients_info = next((p for p in cands if p.exists()), None)
    if patients_info is None:
        raise FileNotFoundError(f"no patients_info manifest under {base} "
                                "(expected patients_info_{dataset}.xlsx/.csv)")
    all_ids = read_patients_info(patients_info)
    slice_ids = sorted(set(all_ids) & set(boxes)) if boxes is not None else sorted(set(all_ids))
    if limit is not None:
        slice_ids = slice_ids[:limit]
    if not slice_ids:
        hint = ""
        if boxes is not None:
            hint = (f"; patients_info ids look like {sorted(set(all_ids))[:3]} vs box "
                    f"'img ID's like {sorted(boxes)[:3]} — check extensions/numeric "
                    "formatting match")
        src = ("between the patients_info manifest and the box manifest"
               if boxes is not None else
               "from the patients_info manifest (no box manifest configured"
               " — empty 'image' column, or a zero limit?)")
        raise ValueError(f"claro_preprocess matched 0 slices {src}{hint}")
    print(f"[claro_preprocess] {len(slice_ids)} slices")
    t0 = time.perf_counter()
    stack, meta = prepare_patient_dataset(
        ctx.data_cfg.data_dir, ctx.data_cfg.dataset, slice_ids, ctx.data_cfg.image_size,
        boxes=boxes, clip=clip, scale=scale, out_dir=ctx.run.interim_dir / "stylegan",
        device=ctx.device)
    t1 = time.perf_counter()
    np.savez_compressed(ctx.run.interim_dir / "claro_preprocessed.npz", images=stack)
    print(f"[claro_preprocess] slices and TIFFs {t1 - t0:.6f} s, npz "
          f"{time.perf_counter() - t1:.6f} s")
    return stack, meta
