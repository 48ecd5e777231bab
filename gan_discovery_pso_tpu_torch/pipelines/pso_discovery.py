"""The PSO discovery stage (counterpart of
`gan_discovery_pso_tpu/pipelines/pso_discovery.py`: `run_pso_discovery`
:41-163, `run_pso_discovery_batched` :166-293, `render_swarm_grids` :310,
`emit_swarm_reports` :366, `_emit_landscape` :420, `_write_overall_history`
:476).

Per IiD class a swarm moves latent vectors of the loaded generator against
the loaded assessor; then the stage writes the reference's artifact set in
the reference's layout (reference src/training/pso_discovery.py:174-254):

- `interim/particles_position_iid_class_{label}.pkl` (+ `iic` alias), the
  velocity pickle and the npz (`pso/io.py`);
- `general/{label}/pso_iter.png`, `mean_mse.png`; at dim 2
  `fitness_grid.pkl` + `img_grid.pkl`;
- `training_plot/{label}/pso_dim_{d}.png`, `pso_dim_last_iteration.png`,
  at dim 2 `2d_plot_{i}.png` + `2dspace_latent.gif`, and the image grids
  `pso_images_{i}.png` + `iid_img.gif`;
- `timing.json` (+ `general/timing.pkl`) and `general/overall_history.pkl`
  (+ `.json`).

Draws: class c's swarm (initial positions and velocities, each iteration's
r1/r2) comes from `ctx.keys.child(f"class_{c}")("pso")`, drawn per class on
the stage's device and injected into the runner, so the batched and the
sequential stage move class c's swarm from the same draws. `draws=` may
override them per class (parity tests feed the JAX package's draws).

A host without pandas, matplotlib or PIL still runs the stage: it prints
one line per artifact family it cannot write, naming the package, and
writes the rest (the npz, the landscape and history pickles, timing.json).

`shard_devices=N` (the CLI's `--shard-swarm N`, JAX `:100-111`) runs on
every rank of a process group of N: each class's swarm goes through
`parallel.make_sharded_discovery_runner`, its particles split over the
ranks, from the same per-class draws, and rank 0 alone writes the
artifacts and the log lines. The log names each rank's backend and
device, each class's collectives and their seconds, and each rank's
kernel launches.
"""

from __future__ import annotations

import json
import pickle
import time

import numpy as np
import torch
from torch import nn

from gan_discovery_pso_tpu_torch.analysis import reporting
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import ResNetDef
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity
from gan_discovery_pso_tpu_torch.pipelines.context import StageContext
from gan_discovery_pso_tpu_torch.pso import (
    OPTIMIZE_OUT,
    SwarmResult,
    draw_uniforms,
    make_batched_discovery_runner,
    make_discovery_fitness_dynamic,
    resolve_fitness_chunk,
    save_particle_histories,
    select_program,
    state_from_positions,
    swarm_init,
)

_FAMILIES = (
    ("pickles", "pandas", "particle pickles (particles_*_class_*.pkl)"),
    ("plots", "matplotlib", "plots (pso_iter.png, mean_mse.png, pso_dim_*.png, "
                            "2d_plot_*.png, 2dspace_latent.gif)"),
    ("grids", "PIL", "image grids (pso_images_*.png, iid_img.gif)"),
)


def _writable(tag: str, make_plots: bool, image_grids: bool) -> dict:
    """{family: the host can write it}; one printed line per family asked
    for whose package is missing."""
    asked = {"pickles": True, "plots": make_plots, "grids": image_grids}
    out = {}
    for family, package, what in _FAMILIES:
        out[family] = reporting.host_has(package)
        if asked[family] and not out[family]:
            print(f"[{tag}] not writing {what}: {package} is not installed")
    return out


def _class_draws(ctx: StageContext, hp: PsoConfig, label, draws) -> tuple:
    """(positions [N, d], velocities [N, d], r1 [iters, N], r2 [iters, N]) of
    class `label`'s swarm, on the stage's device."""
    if draws is not None and label in draws:
        return tuple(x.to(ctx.device, torch.float32) if torch.is_tensor(x)
                     else torch.tensor(x, dtype=torch.float32, device=ctx.device)
                     for x in draws[label])
    g = ctx.keys.child(f"class_{label}")("pso", ctx.device)
    init = swarm_init(g, 1, hp.n_particles, hp.dim_space, hp.w_inertia, ctx.device)
    r1, r2 = draw_uniforms(g, hp.n_iterations, 1, hp.n_particles, ctx.device)
    return init.positions[0], init.velocities[0], r1[:, 0], r2[:, 0]


def _stacked(hp: PsoConfig, per_class: list) -> dict:
    """The runner's draws for swarms stacked in `per_class` order."""
    pos, vel, r1, r2 = zip(*per_class)
    return {"init_state": state_from_positions(torch.stack(pos), torch.stack(vel),
                                               hp.w_inertia),
            "r1": torch.stack(r1, dim=1), "r2": torch.stack(r2, dim=1)}


def run_pso_discovery(
    ctx: StageContext,
    gen_model: nn.Module,
    assessor: nn.Module,
    cnn_def: ResNetDef,
    classes=None,
    control: str = OPTIMIZE_OUT,
    threshold: float = 0.0,
    make_plots: bool = True,
    batch_classes: bool = False,
    image_grids: bool = True,
    tensorboard: bool = False,
    shard_devices: int | None = None,
    fast_math_dtype: torch.dtype | None = None,
    draws: dict | None = None,
) -> dict:
    """Returns {class_label: SwarmResult} (one swarm each). The models are
    passed in, on `ctx.device` (the CLI loads them from the upstream runs).

    The sequential loop over classes, one B = 1 runner for all of them;
    batch_classes=True runs every class's swarm in one batch
    (`run_pso_discovery_batched`). fast_math_dtype=torch.bfloat16 runs the
    forwards on bf16 model copies (the swarm math stays fp32), a caller's
    option as in the JAX package's batched stage; the CLI's `--fast-math`
    instead runs the stage inside `tf32_math()` with fp32 models. shard_devices=N runs each
    class's swarm sharded over the N ranks of the process group this
    process belongs to (module docstring); rank 0 writes."""
    if batch_classes and shard_devices:
        raise ValueError("batch_classes and shard_devices are mutually exclusive")
    if batch_classes:
        return run_pso_discovery_batched(
            ctx, gen_model, assessor, cnn_def, classes=classes, control=control,
            threshold=threshold, make_plots=make_plots, fast_math_dtype=fast_math_dtype,
            image_grids=image_grids, tensorboard=tensorboard, draws=draws)
    hp = PsoConfig.from_config(ctx.cfg.trainer_pso)
    if classes is None:
        classes = ctx.data_cfg.iid_classes
    c2i = cnn_def.class_to_idx()
    mesh = None
    if shard_devices:
        from gan_discovery_pso_tpu_torch.parallel import make_mesh, make_sharded_discovery_runner

        mesh = make_mesh(shard_devices, "swarm", device=ctx.device)
        run = make_sharded_discovery_runner(mesh, hp, control=control, threshold=threshold,
                                            dtype=fast_math_dtype)
        launches0 = _launches()
    else:
        run = make_batched_discovery_runner(hp, control=control, threshold=threshold,
                                            dtype=fast_math_dtype, device=ctx.device)
    writer = mesh is None or mesh.rank == 0
    say = print if writer else (lambda *a, **k: None)
    if mesh is not None:
        _log_ranks(mesh, say)
    can = _writable("pso_discovery", make_plots, image_grids) if writer else None

    if writer:
        ctx.notify("pso_discovery_start", classes=list(classes), hp=repr(hp))
    results: dict = {}
    timings: dict = {}
    overall_history: dict = {}
    fitness_dyn = (_landscape_fitness(hp, make_plots, gen_model, assessor, control, threshold)
                   if writer else None)
    tb_writer = ctx.metrics("img_pso", tensorboard=True) if tensorboard and writer else None
    # every class's swarm is queued before any is collected: the swarms are
    # independent, and the host writes class c's artifacts while the card
    # runs later classes (a sharded run returns each class complete)
    t_start = time.time()
    dispatched = []
    for label in classes:
        before = mesh.collective_stats() if mesh is not None else None
        out = run(gen_model, assessor, [c2i.get(label, 1)],
                  **_stacked(hp, [_class_draws(ctx, hp, label, draws)]))
        if mesh is not None:
            now = mesh.collective_stats()
            say(f"[pso_discovery/sharded] class {label}: {now['all_reduce'] - before['all_reduce']} "
                f"all-reduces in {now['seconds'] - before['seconds']:.6f}s, "
                f"wall {time.time() - t_start:.6f}s")
        dispatched.append((label, out))
    artifact_s = 0.0
    for label, (final, hist, init) in dispatched:
        # a result transfer is the completion barrier; the card runs the
        # swarms in dispatch order, so it covers earlier classes too
        res = SwarmResult(final, hist, init, hp).swarm(0)
        results[label] = res
        timings[f"training_time_class_{label}"] = time.time() - t_start
        if not writer:
            continue
        t_art = time.perf_counter()
        _emit_class(ctx, res, label, gen_model, fitness_dyn, c2i.get(label, 1), can,
                    make_plots, image_grids, tb_writer, overall_history)
        artifact_s += time.perf_counter() - t_art
        print(f"[pso_discovery] class {label}: g_best={float(res.g_best_val):.5f} "
              f"iters={res.last_iteration[0]} in "
              f"{timings[f'training_time_class_{label}']:.1f}s")
    if mesh is not None:
        _log_launches(mesh, launches0, say)
    if not writer:
        return results

    t_art = time.perf_counter()
    ctx.run.write_timing(timings)
    _write_overall_history(ctx, overall_history)
    artifact_s += time.perf_counter() - t_art
    if tb_writer is not None:
        tb_writer.close()
    print(f"[pso_discovery] artifacts written in {artifact_s:.6f}s")
    ctx.notify("pso_discovery_done")
    return results


def _launches() -> dict:
    from gan_discovery_pso_tpu_torch.ops.kernels import KERNELS, SPLIT_KERNELS

    return {k.__name__: k.launches for k in (*SPLIT_KERNELS, *KERNELS)}


def _per_rank(mesh, values: list) -> list:
    """[rank][i] = rank's values[i], on every rank (one all-reduce)."""
    t = torch.zeros((mesh.size(), len(values)), dtype=torch.float64, device=mesh.device)
    t[mesh.rank] = torch.tensor(values, dtype=torch.float64)
    return mesh.all_reduce(t, "sum").tolist()


def _log_ranks(mesh, say) -> None:
    """Each rank's device, as the ranks report it, and the backend."""
    dev = mesh.device
    table = _per_rank(mesh, [-1 if dev.type == "cpu" else dev.index])
    where = ", ".join(f"rank {r} on {'cpu' if i < 0 else f'cuda:{int(i)}'}"
                      for r, (i,) in enumerate(table))
    say(f"[pso_discovery/sharded] {mesh.size()} ranks, backend {mesh.backend}: {where}")


def _log_launches(mesh, before: dict, say) -> None:
    """Each rank's kernel launches in this stage and collective seconds."""
    names = list(before)
    now = _launches()
    table = _per_rank(mesh, [now[k] - before[k] for k in names]
                      + [mesh.collective_stats()["seconds"]])
    per_rank = [{**{k: int(v) for k, v in zip(names, row)}, "collective_s": row[-1]}
                for row in table]
    say(f"[pso_discovery/sharded] launches per rank: {json.dumps(per_rank)}")


def run_pso_discovery_batched(
    ctx: StageContext,
    gen_model: nn.Module,
    assessor: nn.Module,
    cnn_def: ResNetDef,
    classes=None,
    control: str = OPTIMIZE_OUT,
    threshold: float = 0.0,
    make_plots: bool = True,
    fast_math_dtype: torch.dtype | None = None,
    image_grids: bool = True,
    tensorboard: bool = False,
    draws: dict | None = None,
) -> dict:
    """All class swarms in one batch: every iteration runs the generator and
    the assessor over n_classes · n_particles latents. The swarms stay
    independent (the reference's never-communicating swarms, SURVEY.md
    §5.8). `trainer_pso.fitness_chunk` chunks the forwards (`pso/runner.py`),
    which leaves the values as they are; `trainer_pso.program` is checked
    and chooses nothing on the card."""
    hp = PsoConfig.from_config(ctx.cfg.trainer_pso)
    if classes is None:
        classes = ctx.data_cfg.iid_classes
    c2i = cnn_def.class_to_idx()
    idxs = [c2i.get(c, 1) for c in classes]
    can = _writable("pso_discovery/batched", make_plots, image_grids)
    tb_writer = ctx.metrics("img_pso", tensorboard=True) if tensorboard else None

    fitness_chunk = resolve_fitness_chunk(
        ctx.cfg.trainer_pso.get("fitness_chunk", "auto"), hp.n_particles)
    select_program(str(ctx.cfg.trainer_pso.get("program", "auto")))
    run = make_batched_discovery_runner(hp, control=control, threshold=threshold,
                                        dtype=fast_math_dtype, fitness_chunk=fitness_chunk,
                                        device=ctx.device)
    stacked = _stacked(hp, [_class_draws(ctx, hp, label, draws) for label in classes])

    t0 = time.time()
    finals, hists, inits = run(gen_model, assessor, idxs, **stacked)
    finals.g_best_val.cpu()  # a result transfer: the completion barrier
    wall = time.time() - t0

    fitness_dyn = _landscape_fitness(hp, make_plots, gen_model, assessor, control, threshold)
    t_art = time.perf_counter()
    batch = SwarmResult(finals, hists, inits, hp)
    results: dict = {}
    overall_history: dict = {}
    for i, label in enumerate(classes):
        res = batch.swarm(i)
        results[label] = res
        _emit_class(ctx, res, label, gen_model, fitness_dyn, c2i.get(label, 1), can,
                    make_plots, image_grids, tb_writer, overall_history)
        print(f"[pso_discovery/batched] class {label}: "
              f"g_best={float(res.g_best_val):.5f} iters={res.last_iteration[0]}")
    if tb_writer is not None:
        tb_writer.close()
    ctx.run.write_timing({"training_time_all_classes": wall})
    _write_overall_history(ctx, overall_history)
    print(f"[pso_discovery/batched] {len(classes)} swarms in {wall:.2f}s wall")
    print(f"[pso_discovery/batched] artifacts written in {time.perf_counter() - t_art:.6f}s")
    return results


def _landscape_fitness(hp, make_plots, gen_model, assessor, control, threshold):
    """The class-indexed fitness the dim-2 landscape needs, else None."""
    if make_plots and hp.dim_space == 2:
        return make_discovery_fitness_dynamic(gen_model, assessor, control=control,
                                              threshold=threshold)
    return None


def _emit_class(ctx, res, label, gen_model, fitness_dyn, class_idx, can, make_plots,
                image_grids, tb_writer, overall_history) -> None:
    """One class's artifacts (reference :222-240)."""
    save_particle_histories(ctx.run.interim_dir, label, res.particle_trajectories(),
                            res.velocity_trajectories(), kind="iid", pickles=can["pickles"])
    overall_history[f"class_{label}"] = res.history_dict()
    if make_plots:
        fitness = None
        if fitness_dyn is not None:
            fitness = lambda pos, **kw: fitness_dyn(pos, class_idx, **kw)  # noqa: E731
        emit_swarm_reports(ctx, res, label, fitness=fitness, title=f"class {label}")
    if image_grids and can["grids"]:
        render_swarm_grids(ctx, gen_model, res, label, writer=tb_writer)


def _generate(gen_model: nn.Module, z: np.ndarray) -> np.ndarray:
    """Generator images of latents z [M, d, 1, 1], fp32, on the host."""
    device = next(gen_model.parameters()).device
    with fp32_parity(), torch.inference_mode():
        return gen_model(torch.as_tensor(z, dtype=torch.float32, device=device)).cpu().numpy()


def render_swarm_grids(
    ctx: StageContext,
    gen_model: nn.Module,
    res: SwarmResult,
    label,
    writer=None,
    ncols: int = 8,
    tag: str | None = None,
):
    """Per-iteration generated-image grids `training_plot/{label}/
    pso_images_{i}.png` and `iid_img.gif` (reference src/pso/util_pso.py:
    114-133), rendered after the run from the recorded trajectories: the
    positions iteration i evaluated are trajectory row i-1, and ONE
    generator forward covers every recorded iteration."""
    out_dir = ctx.run.reports_dir / "training_plot" / str(label)
    out_dir.mkdir(parents=True, exist_ok=True)
    pre_move = res.particle_trajectories()[:-1]  # eval positions of iterations 1..n_act
    n_it, n_p, d = pre_move.shape
    if n_it == 0:
        return []
    imgs = _generate(gen_model, pre_move.reshape(n_it * n_p, d, 1, 1))
    imgs = imgs.reshape(n_it, n_p, *imgs.shape[1:])
    paths = []
    for i in range(n_it):
        # G output is tanh: drange (-1, 1), like the reference's particles
        paths.append(reporting.save_image_grid(
            imgs[i], out_dir / f"pso_images_{i + 1}.png", ncols=ncols, drange=(-1, 1)))
        if writer is not None:
            # one shared writer, so the class goes into the tag
            writer.add_image(tag if tag is not None else f"Real/class_{label}",
                             reporting.grid_canvas(imgs[i], ncols=ncols, drange=(-1, 1)),
                             step=i + 1)
    reporting.make_gif(paths, out_dir / "iid_img.gif")
    return paths


def emit_swarm_reports(
    ctx: StageContext,
    res: SwarmResult,
    sub,
    fitness=None,
    title: str = "",
    resolution: int = 100,
    span: float = 5.0,
    save_img_grid: bool = True,
):
    """The reference's per-swarm report set (reference
    src/training/pso_discovery.py:222-237): `general/{sub}/pso_iter.png`,
    `mean_mse.png`; `training_plot/{sub}/pso_dim_{d}.png`,
    `pso_dim_last_iteration.png`; at dim_space 2 with a fitness the
    landscape (`_emit_landscape`). Plots use the positions fitness was
    evaluated at (trajectory rows :-1). Without matplotlib only the
    landscape's pickles are written.

    fitness(positions [M, 2], return_images=False) → [M] (with the images:
    (values, (rescaled images, generator images)))."""
    general = ctx.run.reports_dir / "general" / str(sub)
    plots = ctx.run.reports_dir / "training_plot" / str(sub)
    general.mkdir(parents=True, exist_ok=True)
    plots.mkdir(parents=True, exist_ok=True)
    draw = reporting.host_has("matplotlib")

    eval_rows = res.particle_trajectories()[:-1]  # [n_act, N, d]
    if draw:
        hd = res.history_dict()
        reporting.plot_convergence(hd["global_best_val"], general / "pso_iter.png",
                                   title=title or f"swarm {sub}")
        reporting.plot_mean_mse(hd["mean_mse"], general / "mean_mse.png")
        reporting.plot_particle_dimensions(eval_rows, plots, prefix="pso_dim")
        reporting.plot_particles_last_iteration(eval_rows[-1],
                                                plots / "pso_dim_last_iteration.png")
    if res.hp.dim_space == 2 and fitness is not None:
        _emit_landscape(res, fitness, general, plots, resolution=resolution, span=span,
                        save_img_grid=save_img_grid, frames=draw)
    return general, plots


def _emit_landscape(res: SwarmResult, fitness, general, plots, resolution: int = 100,
                    span: float = 5.0, save_img_grid: bool = True, frames: bool = True):
    """2-D landscape artifacts (reference plot2d, util_report.py:82-141 +
    pso_discovery.py:226-232): a mesh of g_best ± span, its fitness and its
    rescaled images from ONE fitness call (`fitness_grid.pkl`,
    `img_grid.pkl` in float16), and with `frames` a `2d_plot_{i}.png` per
    recorded iteration plus `2dspace_latent.gif`."""
    center = res.g_best_pos[0].numpy()
    xs = np.linspace(center[0] - span, center[0] + span, resolution)
    ys = np.linspace(center[1] - span, center[1] + span, resolution)
    gx, gy = np.meshgrid(xs, ys)
    mesh = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)
    vals, (img01, _img) = fitness(mesh, return_images=True)
    z_grid = vals.cpu().numpy().reshape(resolution, resolution)
    with open(general / "fitness_grid.pkl", "wb") as f:
        pickle.dump(z_grid, f)
    if save_img_grid:
        # the per-sample [0,1] image at every mesh point, like
        # Discovery.particles_to_img (util_discovery.py:33-50)
        with open(general / "img_grid.pkl", "wb") as f:
            pickle.dump(img01.cpu().numpy().astype(np.float16), f)
    if not frames:
        return
    serve = lambda _mesh: z_grid.ravel()  # noqa: E731  every frame reuses the grid
    eval_rows = res.particle_trajectories()[:-1]
    paths = [reporting.plot_fitness_landscape_2d(
                 serve, center=center, out_path=plots / f"2d_plot_{it}.png",
                 positions=eval_rows[it], span=span, resolution=resolution)
             for it in range(eval_rows.shape[0])]
    reporting.make_gif(paths, plots / "2dspace_latent.gif")


def _write_overall_history(ctx: StageContext, overall_history: dict):
    """`general/overall_history.pkl` (reference pso_discovery.py:250-251) and
    a readable JSON twin."""
    ctx.run.write_overall_history(overall_history)
    with open(ctx.run.general_dir / "overall_history.json", "w") as f:
        json.dump({k: {kk: [float(x) for x in vv] for kk, vv in v.items()}
                   for k, v in overall_history.items()}, f, indent=2)
