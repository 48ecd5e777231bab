#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (`gan_discovery_pso_tpu_torch`).

Run from the root of a checkout on a host with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `gan_discovery_pso_tpu_torch/csrc/`,
holds each kernel against its plain PyTorch version on the card (bit for
bit) at the main path's shapes and at the edges of their range (B = 1,
stacked swarms, odd and unaligned sizes, N = 4096 x d = 1024, 4096 images,
long rows), drives the main path — the batched PSO discovery sweep, 8
classes x 32 particles x 50 iterations, z=100, DCGAN G(64), ResNet-50 with
8 classes, seeded random weights — in fp32 parity mode and in bf16, checks
that every kernel of the path launched once per iteration, profiles one
fp32 and one bf16 run, checks the results (finite, in [eps, 1+eps],
reproducible, the bf16 gate, agreement with the CPU path on a small
input), runs the pso-discovery stage through its CLI on JAX-format
checkpoints of the same models (the pipeline phase, between the main-path
runs and the first profiler session: batched fp32 bit-equal to the runner,
sequential, the shipped dimension 2 with its landscape, bf16), runs the
pso-inverter stage through its CLI (the inverter phase, right after: a
seeded encoder f=64 z=100 beside G and the ResNet-50 as JAX-format
checkpoints, a 1-epoch fine-tune of the re-headed binary assessor on the
synthetic digits, 256 encoder-seeded particles x 50 iterations; the
try-load rerun and the runner called directly bit-equal to it; bf16; 5
fine-tune steps profiled), runs the inverter and the two regularize stages
through their CLI (the inverter training phase: 1-epoch pix_fea_rec_adv,
pix_rec and AttGAN runs at the shipped widths on the same checkpoints, each
encoder read back bit-equal; 5 steady steps of each kind profiled;
regularize-inverter on 8 OoD images x 500 iterations with a bit-equal
rerun; regularize-inverter-statistics on the pipeline phase's particles;
one step of each kind and 10 invert iterations on the card against the
CPU; no port kernel on these paths, 0 launches each), runs the assessor and
evaluation stages through their CLI (the assessor and evaluation phase:
`cae` at latent 10 and batch 128 for 1 epoch, `classifiers` on it with the
test split's KNN posterior on the card against the CPU, equal but for
near-ties; `cnn-multipatient` with ResNet-50 and `pso-discovery
--batch-classes` on the model.msgpack it wrote, 50 launches each; `cnn`, 8
ResNet-50s on 2048 images; an AlexNet cnn-multipatient under the batched
runner, 50 launches each; every checkpoint read back bit-equal; then
`evaluate_gan_epoch` over 12,800 samples of G(64), B2 10 launches at
[1280, 784], FID, IS, rec and one evaluation profiled; 1280 samples on the
card against the CPU), runs the DCGAN and the VQ-VAE stages through their
CLI (the dcgan and vq-vae phase: `dcgan` at the shipped widths, z 10, f 64,
batch 128, for 2 epochs on that phase's CAE and battery, B2 10 launches an
epoch, FID, IS and rec finite; 1 + 1 resumed epochs byte-equal to the 2;
5 steady train steps profiled and one step on the card against the CPU;
`vqvae` at embedding 100 and K 256, 1 epoch, its decoder the main path's
G and its codebook the pipeline phase's batched particles, checked at init,
its decoder bit-equal to G after training and a rerun byte-equal;
`pixelcnn-prior` on it, 1 epoch; no port kernel in the last two), runs the
latent analyses and the CLARO export through their CLI (the analysis and
CLARO phase: `pso-analysis` on the pipeline phase's particles, 51 PCA +
UMAP fits of 256 x 100; `pso-analysis-clustering` with kmeans and em, the
inverter phase's 256 OoD latents overlaid, and on the dimension-2 run;
`pso-analysis-distance`; `pso-inverter-analysis`; `claro-preprocess` on 2 x
64 CT slices of 512 x 512 at 256, a rerun byte-equal; `augment_batch` on
the 128 slices; PCA, the labels, UMAP's graph and 10 layout epochs, the
distances, the resize, the stack and the augmentation on the card against
the CPU; no port kernel on these paths), runs the parallel paths (the
parallel phase, after the timings below and every profiler session:
`pso-discovery --shard-swarm 2`, whose two ranks the CLI starts on the
one card over gloo under this process's GPU lease, each class's swarm
split 16 + 16 and
moved by B1's split halves around the global-best all-reduces, within
rtol 1e-4 of the sequential run; the batched sharded runner at world 1
under NCCL, bit-equal to the batched runner; 4 ranks running the 2 x 2
class x swarm runner against the batched runner and the data-parallel GAN
step at the shipped widths against the one-process step; the split halves
are held bit-equal to their plain versions, shard by shard and together
against the fused plain version, before the main path runs), then the
remainder phase, last (`export-model fitness` and `generator` loaded
again and held to the runner, one B2 launch a fitness call through B2's
registered operator, itself bit-equal to the plain version; `sweep
--latent-dims 10` with a dcgan and a sequential pso-discovery leg, and one
patient x both controls of pso-inverter, every leg under the GPU lease
with its launches counted; `export-torch` then `convert-torch` of the
card-trained G, bit-equal; a `core.trace` file naming B1 and B2; the GAN
step's 30-step loss-trajectory gate under TF32 and the bf16 step; reduced
`--fast-math` runs of five training stages beside their fp32-parity
runs), timing each kernel at the main path's shape and at a large one
before the parallel phase (device µs per launch from the profiler over
the last 50 of 80 calls in a session, as the profiler loses the kernel
events of a session's first calls; beside the bound), and prints:

    card: <nvidia-smi name, power limit>
    ... progress lines ...
    {"kernels": [...]}          one line: per kernel, times, bounds, launches
    {"ok": true, "device": {...}}   the last line

Every failure raises and exits non-zero; no phase catches its own failure.
It exits non-zero with no result where CUDA is missing or the package is
not beside the script. It imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import itertools
import json
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_CLASSES, N_PARTICLES, N_ITERATIONS, DIM = 8, 32, 50, 100
INV_PARTICLES, PATIENT = 256, 1  # the pso-inverter's swarm, its OoD patient
EPS = 0.1
SEED = 0
GATE = 1e-3  # |g_best fp32 - bf16|, bench.py's gate
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32, outside the tensor cores
TIMED_LAUNCHES = 200
PROFILED_LAUNCHES = 50
PROFILER_SESSIONS = 5  # tries at a session that keeps its timed launches
# calls a session makes before its timed ones: a session loses the kernel
# events of its first 0-2 calls as a rule, and in some full runs of this
# script lost those of its first 8-15 calls in every session (now and then
# all of a session's calls: `device_us` then tries again)
PROFILER_LEAD_CALLS = 30
GRAPH_REPLAYS = 20  # replays of a graph of PROFILED_LAUNCHES calls, timed together
L2_BYTES = 50 * 2**20  # H100 L2
LANDSCAPE = 100  # points per axis of the stage's 2-D fitness mesh
SEQ_TOL = 1e-4  # sequential vs batched g_best (tests/test_pipeline_e2e.py:511-514)
CFG = ROOT / "configs" / "dcgan_mnist.yaml"
# B1 bit-equality shapes [B, N, d]: the main path, 256 particles, unpadded,
# the B = 1 runner, the stacked x4 program, N and d fitting no tile or
# float4, the Pallas kernel's range, and d past the g-best row staged in
# shared memory (1024), with and without float4; the shipped dimension
# d = 2 (scalar rows), batched and sequential
SWARM_SHAPES = ((N_CLASSES, N_PARTICLES, DIM), (N_CLASSES, 256, DIM), (3, 13, 7),
                (1, N_PARTICLES, DIM), (4 * N_CLASSES, N_PARTICLES, DIM), (2, 37, 13),
                (1, 4096, 1024), (1, 16, 2048), (2, 9, 1030),
                (N_CLASSES, N_PARTICLES, 2), (1, N_PARTICLES, 2), (1, INV_PARTICLES, DIM))
SWARM_TIMED = ((N_CLASSES, N_PARTICLES, DIM), (1, 4096, 1024), (1, INV_PARTICLES, DIM))
# B2 [N, F]: the main path's images, short unaligned and odd rows, many rows,
# rows in registers at every team size (8, 4, 2, 1 warps) and register
# depth (1 to 32 float4 a thread), long rows (one CTA each; 65536 = a
# 256x256 CLARO slice, 4099 odd), the 2-D landscape's 100x100 mesh, the
# GAN evaluation sampler's chunk of 1280 images, and one rank's images on
# the parallel phase's sharded paths: a class's swarm over SHARDS ranks, and
# a GRID rank's classes x particles
SHARDS = 2  # ranks of the parallel phase's sharded swarm
GRID = (2, 2)  # the class x swarm runner's mesh
RESCALE_SHAPES = ((N_CLASSES * N_PARTICLES, 784), (9, 300), (5, 301), (4096, 784),
                  (600, 1500), (1500, 2049), (3000, 203), (2100, 4000),
                  (4, 65536), (3, 4099), (LANDSCAPE ** 2, 784), (1280, 784),
                  (N_PARTICLES // SHARDS, 784),
                  ((N_CLASSES // GRID[0]) * (N_PARTICLES // GRID[1]), 784))
RESCALE_TIMED = ((N_CLASSES * N_PARTICLES, 784), (4096, 784))
N_SYNTHETIC = 12800  # images of one GAN evaluation (evaluate_gan_epoch's default)
# device kernel names of each wrapper, as the profiler reports them
KERNEL_NAMES = {"swarm_update": ("swarm_update_kernel",),
                "rescale01_rows": ("rescale_short_kernel", "rescale_long_kernel"),
                "swarm_pbest_local": ("swarm_pbest_local_kernel",),
                "swarm_move": ("swarm_move_kernel",)}
# the parallel phase: B1's split halves at the main path's swarm halved,
# stacked, half of B1's large shape, odd rows and d, d past float4, and the
# shipped dimension 2, each cut into SHARDS shards
SPLIT_SHAPES = ((1, N_PARTICLES // 2, DIM), (N_CLASSES, N_PARTICLES // 2, DIM), (1, 2048, 1024),
                (3, 13, 7), (2, 9, 1030), (N_CLASSES, N_PARTICLES, 2))
SPLIT_TIMED = ((1, N_PARTICLES // 2, DIM), (N_CLASSES, N_PARTICLES // 2, DIM), (1, 2048, 1024))
GRID_ITERATIONS = 10  # the class x swarm runner's depth (the main path runs 50);
# the DP GAN step runs on each of its swarm-axis pairs


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int = TIMED_LAUNCHES) -> float:
    """Mean time per call over `launches` back-to-back calls, between two
    CUDA events: the larger of the host's time to issue a call and the
    device's time to run it."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def in_turns(kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bits_equal(a, b) -> float:
    """Raise unless a and b hold the same bits (any NaN matches any NaN);
    return max |a - b| over the non-NaN entries (0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if not a.is_floating_point():
        if not torch.equal(a, b):
            raise AssertionError(f"{a.dtype} outputs differ")
        return 0.0
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        raise AssertionError("NaN positions differ")
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    same = (a.view(ints) == b.view(ints)) | nan_a
    if not bool(same.all()):
        diff = (a.float() - b.float()).abs().nan_to_num(0.0).max()
        raise AssertionError(f"{int((~same).sum())} entries differ, max |diff| {float(diff)}")
    return 0.0


def zero_counts(kernels) -> None:
    """Set every kernel's launch count to 0, the card idle first."""
    import torch

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0


def log_seconds(text: str, pattern: str) -> float:
    """The number `pattern`'s group captures in the last matching line."""
    import re

    return float(re.findall(pattern, text)[-1])


def build_models(device):
    import torch

    from gan_discovery_pso_tpu_torch.models import (
        Generator, GeneratorDef, ResNet, ResNetDef, dcgan_init_, glorot_normal_init_)

    rng = torch.Generator(device=device).manual_seed(SEED)
    gen = dcgan_init_(Generator(GeneratorDef(DIM, 1, 64), device=device), rng).eval()
    cnn = glorot_normal_init_(
        ResNet(ResNetDef("ResNet50", 1, N_CLASSES), device=device), rng).eval()
    return gen, cnn


def real_fitness(models, positions, classes):
    """Full-width G + ResNet-50 fitness [B, N] at positions [B, N, d]."""
    import torch

    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.pso import apply_discovery_fitness

    b, n, d = positions.shape
    with fp32_parity(), torch.no_grad():
        vals = apply_discovery_fitness(positions.reshape(b * n, d), *models,
                                       classes.repeat_interleave(n), eps=EPS)
    return vals.reshape(b, n)


def swarm_update_work(b, n, d, n_improved) -> tuple[int, int]:
    """(bytes, fp32 operations): each input read once, each output written
    once; p_best_pos rows of particles that improved are not needed (the
    kernel skips them)."""
    nbytes = 4 * (3 * b * n * d - n_improved * d + 4 * b * n + b * d + 3 * b)  # inputs
    nbytes += 4 * (3 * b * n * d + b * n + b * d + 2 * b) + b  # outputs
    return nbytes, 10 * b * n * d + 2 * b * n


def rescale_work(n, f, out_bytes) -> tuple[int, int]:
    return 4 * n * f + out_bytes * n * f, 6 * n * f


def bound_ms(nbytes, ops) -> tuple[float, str]:
    """The least time for the work on the card, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def profile_session(fn, kernel_names, launches: int = PROFILED_LAUNCHES,
                    lead_calls: int = PROFILER_LEAD_CALLS) -> tuple[list, dict]:
    """One profiler session over `lead_calls + launches` calls of `fn`:
    (device µs of the last `launches` kept kernel events, the session's
    record). Kernel events are the device events whose name holds one of
    `kernel_names`. The record holds the calls, the launch-API events and
    kernel events kept, and, where each call launched one kernel, the
    calls (by index in call order) whose kernel event was lost: a call and
    its kernel share a correlation id."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = lead_calls + launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    start = lambda e: e.time_range.start  # noqa: E731
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and any(k in e.name for k in kernel_names)), key=start)
    api = sorted((e for e in events
                  if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name), key=start)
    kept_ids = {e.id for e in kernels}
    record = {"calls": calls, "launch_api": len(api), "kept": len(kernels),
              "calls_without_kernel": ([i for i, e in enumerate(api) if e.id not in kept_ids]
                                       if len(api) == calls else None)}
    return [e.time_range.elapsed_us() for e in kernels[-launches:]], record


def leading_loss(record: dict) -> bool:
    """The session lost the kernel events of its first calls and no other:
    what the profiler does on the card (profiler_check.py, PERF.md §6)."""
    lost = record["calls_without_kernel"]
    return lost is not None and lost == list(range(len(lost)))


def graph_us(fn, launches: int = PROFILED_LAUNCHES, replays: int = GRAPH_REPLAYS) -> float:
    """Device µs per launch of `fn`'s kernel from a CUDA graph of `launches`
    calls, replayed `replays` times between two CUDA events: the kernels'
    time plus the graph's gaps between them, so at least the kernel's
    device time. No profiler is involved."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * launches)


def device_us(fn, kernel_names, launches: int = PROFILED_LAUNCHES,
              sessions: int = PROFILER_SESSIONS) -> tuple[float | None, int, list]:
    """(device µs per launch, launches measured, the session records) of
    `fn`'s kernel over `launches` standalone launches, from the profiler's
    device events. The profiler loses the kernel events of a session's
    first calls (0-15 as a rule, now and then all of them): each session
    makes PROFILER_LEAD_CALLS calls before the timed ones and measures the
    last `launches` kernel events it kept. A
    session that lost more than its lead calls, all of them first calls,
    is made again, up to `sessions`; where none kept enough, the µs are
    None (the caller then reads `graph_us`). A session that lost a later
    call, or kept more events than it made calls, fails."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    records = []
    for _ in range(sessions):
        times, record = profile_session(fn, kernel_names, launches)
        records.append(record)
        if record["kept"] > record["calls"] or (
                record["calls_without_kernel"] and not leading_loss(record)):
            raise AssertionError(f"profiler session {record} of {kernel_names}: "
                                 "not a loss of its first calls")
        if record["kept"] >= launches:
            return sum(times) / len(times), len(times), records
    log(f"profiler sessions {records} kept fewer than {launches} events of "
        f"{kernel_names}: device µs from the CUDA graph replay")
    return None, 0, records


def time_shape(kernel, plain, arg_sets, kernel_names, shape, bound) -> dict:
    """A kernel at one shape, standalone: device µs per launch (profiler),
    per-call ms of kernel and plain version (events, in turns), and the
    bound. Launches cycle over `arg_sets`, copies of one input at other
    addresses, so that a large shape does not find its input in L2."""
    cycle = itertools.cycle(arg_sets)
    k = lambda: kernel(*next(cycle))
    ms, plain_ms = in_turns(k, lambda: plain(*next(cycle)))
    us, profiled, sessions = device_us(k, kernel_names)
    replay_us = graph_us(k)
    b_ms, bound_by = bound
    device = us if us is not None else replay_us
    return {"shape": list(shape), "device_us": device,
            "device_us_from": "profiler" if us is not None else "graph replay",
            "graph_replay_us": replay_us, "ms": ms, "plain_ms": plain_ms,
            "bound_us": b_ms * 1e3, "bound_by": bound_by,
            "share_of_bound": b_ms * 1e3 / device, "input_copies": len(arg_sets),
            "profiled_launches": profiled, "profiler_sessions": sessions}


def time_kernel(record, kernel, plain, to_time) -> None:
    """Time a kernel at each (shape, args, work, cold) of `to_time` and put
    the first shape's numbers into its record. A cold shape cycles through
    copies of its input past the L2; the main path's shape does not, as the
    main path hands the kernel data just written."""
    timed = []
    for shape, args, work, cold in to_time:
        arg_sets = copies_for_l2(args, work[0]) if cold else [args]
        timed.append(time_shape(kernel, plain, arg_sets, KERNEL_NAMES[record["name"]],
                                shape, bound_ms(*work)))
        log(f"{record['name']} timed: {json.dumps(timed[-1])}")
    main = timed[0]
    record.update(ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_us"] * 1e-3,
                  bound_by=main["bound_by"], timed=timed)


def copies_for_l2(args, nbytes) -> list:
    """`args` and enough clones that cycling through them touches more than
    twice the card's L2 between two uses of one copy."""
    import torch

    n = 1 + min(7, -(-2 * L2_BYTES // max(nbytes, 1)))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(n - 1)]


def check_swarm_update(models, device) -> tuple[dict, list]:
    """B1 against its plain version over chained iterations at every shape
    of SWARM_SHAPES: real fitness values where d is the generator's, forced
    exact ties, and an all-inf start. Returns the kernel's record (without
    times and launches) and what `time_kernel` times at SWARM_TIMED."""
    import torch

    from gan_discovery_pso_tpu_torch.ops.kernels import swarm_update, swarm_update_plain
    from gan_discovery_pso_tpu_torch.pso import state_from_positions

    rng = torch.Generator(device=device).manual_seed(SEED + 1)
    err = 0.0
    timed_args = {}
    for b, n, d in SWARM_SHAPES:
        pos = torch.randn((b, n, d), generator=rng, device=device)
        vel = (torch.randn((b, n, d), generator=rng, device=device) - 0.5) / 10.0
        s = state_from_positions(pos, vel, 0.73)
        classes = torch.arange(b, device=device) % N_CLASSES
        for it in range(5):
            if it == 0:
                fit = torch.full((b, n), torch.inf, device=device)  # nothing improves
            elif d == DIM:
                fit = real_fitness(models, s.positions, classes)
            else:
                fit = (s.positions * s.positions).sum(dim=2)
            if it >= 2:  # exact ties at the minimum: the first index must win
                lo = fit.amin(dim=1, keepdim=True)
                fit[:, 1::3] = lo
            r1 = torch.rand((b, n), generator=rng, device=device)
            r2 = torch.rand((b, n), generator=rng, device=device)
            w = torch.full((b,), 0.73 * 0.99 ** it, device=device)
            args = (s.positions, s.velocities, s.p_best_pos, s.p_best_val, fit, r1, r2,
                    s.g_best_pos, s.g_best_val, s.g_prev_val, w, 1.496, 1.496)
            got, want = swarm_update(*args), swarm_update_plain(*args)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                err = max(err, bits_equal(x, y))
            s = s._replace(positions=got.positions, velocities=got.velocities,
                           p_best_pos=got.p_best_pos, p_best_val=got.p_best_val,
                           g_best_pos=got.g_best_pos, g_best_val=got.g_best_val,
                           g_prev_val=got.g_prev_val)
            timed_args[(b, n, d)] = args
        log(f"swarm_update [{b},{n},{d}]: bit-equal to plain over 5 iterations")
    to_time = [(shape, timed_args[shape],
                swarm_update_work(*shape, int((timed_args[shape][4] < timed_args[shape][3]).sum())),
                shape == (1, 4096, 1024))
               for shape in SWARM_TIMED]
    return {"name": "swarm_update", "route": "cuda",
            "source": "gan_discovery_pso_tpu_torch/csrc/swarm_update.cu",
            "replaces": "gan_discovery_pso_tpu/ops/pallas/swarm_update.py:32",
            "max_abs_err": err, "library_ms": None, "parity": "bitwise",
            "shape": list(SWARM_TIMED[0])}, to_time


def check_rescale(models, device) -> tuple[dict, list]:
    """B2 against its plain version at every shape of RESCALE_SHAPES (the
    first from real G images; one an offset view, whose base is not 16-byte
    aligned), each with a constant row: fp32 bit-equal, bf16 equal to
    plain-then-cast. Returns the kernel's record (without times and
    launches) and what `time_kernel` times at RESCALE_TIMED in fp32."""
    import torch

    from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_rows, rescale01_rows_plain

    rng = torch.Generator(device=device).manual_seed(SEED + 2)
    z = torch.randn((N_CLASSES * N_PARTICLES, DIM, 1, 1), generator=rng, device=device)
    with torch.no_grad():
        imgs = models[0](z).reshape(N_CLASSES * N_PARTICLES, -1)
    inputs = {}
    for n, f in RESCALE_SHAPES:
        if (n, f) == (N_CLASSES * N_PARTICLES, 784):
            x = imgs
        else:
            x = torch.randn((n, f), generator=rng, device=device)
        inputs[(n, f)] = x
    # an offset view: rows of odd length from a base 4 bytes past alignment
    inputs["offset view"] = torch.randn((6, 301), generator=rng, device=device)[1:]
    err = 0.0
    for label, x in inputs.items():
        c = min(3, x.shape[0] - 1)
        x[c] = 0.25  # constant row: 0/0 → NaN
        for out_dtype in (torch.float32, torch.bfloat16):
            got, want = rescale01_rows(x, out_dtype), rescale01_rows_plain(x, out_dtype)
            torch.cuda.synchronize()
            err = max(err, bits_equal(got, want))
            if not bool(torch.isnan(got[c]).all()):
                raise AssertionError("a constant row must give NaN")
        log(f"rescale01_rows {list(x.shape)} ({label}, base % 16 = {x.data_ptr() % 16}): "
            "bit-equal to plain in fp32 and bf16")
    to_time = [((n, f), (inputs[(n, f)],), rescale_work(n, f, 4),
                (n, f) != (N_CLASSES * N_PARTICLES, 784))
               for n, f in RESCALE_TIMED]
    return {"name": "rescale01_rows", "route": "cuda",
            "source": "gan_discovery_pso_tpu_torch/csrc/rescale.cu",
            "replaces": "gan_discovery_pso_tpu/ops/pallas/rescale.py:38",
            "max_abs_err": err, "library_ms": None, "parity": "bitwise",
            "shape": list(RESCALE_TIMED[0])}, to_time


def drive_main_path(models, device, dtype, kernels, hp=None, classes=None, **draws):
    """One run of the batched runner; returns (final, history, seconds,
    launches per kernel). The launch counts are zeroed just before. Draws
    not given come from a generator seeded with SEED + 3."""
    import torch

    from gan_discovery_pso_tpu_torch.core import PsoConfig
    from gan_discovery_pso_tpu_torch.pso import make_batched_discovery_runner

    hp = hp or PsoConfig(n_iterations=N_ITERATIONS, n_particles=N_PARTICLES, dim_space=DIM)
    classes = list(range(N_CLASSES)) if classes is None else classes
    run = make_batched_discovery_runner(hp, eps=EPS, dtype=dtype, device=device)
    rng = torch.Generator(device=device).manual_seed(SEED + 3)
    zero_counts(kernels)
    t0 = time.perf_counter()
    final, hist, _ = run(*models, classes, rng=rng, **draws)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return final, hist, seconds, {k.__name__: k.launches for k in kernels}


def profile_main_path(models, device, kernels, dtype=None) -> dict:
    """One main-path run (fp32, or `dtype`) under torch.profiler: wall time,
    device busy time (the sum of the device intervals of kernels, copies and
    sets on the one stream), the idle share, device µs per launch of each
    port kernel, and the kernels taking most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, seconds, _ = drive_main_path(models, device, dtype, kernels)
    return device_summary(prof, seconds)


def device_summary(prof, seconds: float) -> dict:
    """A profiled run's wall time, device busy time (the sum of the device
    intervals of kernels, copies and sets on the one stream), idle share,
    device µs per launch of each port kernel, and the kernels taking most
    device time."""
    from torch.autograd import DeviceType

    per_name: dict = {}
    for e in prof.events():
        # a user annotation on the device timeline (Optimizer.step#Adam.step)
        # spans kernels that are counted themselves
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            total, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    busy_us = sum(t for t, _ in per_name.values())
    if busy_us == 0:
        return {"device_time": "not measured (the profiler recorded no device events)"}
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    ours = {}
    for name, kernel_names in KERNEL_NAMES.items():
        hits = [v for k, v in per_name.items() if any(kn in k for kn in kernel_names)]
        ours[name] = (sum(t for t, _ in hits), sum(c for _, c in hits))
    return {
        "wall_ms": seconds * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / (seconds * 1e6),
        "port_kernels_us_per_launch": {k: t / c for k, (t, c) in ours.items() if c},
        "top_device_kernels": [{"name": k[:90], "ms": t / 1e3, "count": c}
                               for k, (t, c) in top],
    }


def profile_steps(step, batches, warm_up: int = 2) -> dict:
    """`step(*batch)` over `batches` in fp32 parity, the first `warm_up`
    outside torch.profiler and the rest under it: per-step wall ms, and the
    device summary over the profiled steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gan_discovery_pso_tpu_torch.ops import fp32_parity

    with fp32_parity():
        for batch in batches[:warm_up]:
            step(*batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches[warm_up:]:
                step(*batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    steps = len(batches) - warm_up
    return {"steps": steps, "wall_ms_per_step": seconds * 1e3 / steps,
            **device_summary(prof, seconds)}


def profile_fine_tune(fine, ds, adam, steps: int = 5) -> dict:
    """`steps` train steps of the pso-inverter's fine-tune (a copy of the
    binary assessor, batches of 128 of `ds` in the stage's drange, fp32
    parity) under torch.profiler, after 2 warm-up steps."""
    import copy

    import torch

    from gan_discovery_pso_tpu_torch.train.cnn import EpochCounts, make_cnn_steps
    from gan_discovery_pso_tpu_torch.train.common import make_optimizer

    model = copy.deepcopy(fine)
    train_step, _ = make_cnn_steps(model, make_optimizer(adam, model.parameters()))
    idx = torch.arange(128 * (steps + 2), device=ds.images.device) % ds.images.shape[0]
    batches = [(ds.images[i], (ds.labels[i] == PATIENT).to(torch.int32))
               for i in idx.split(128)]
    return profile_steps(lambda x, y: train_step(x, y, EpochCounts.zero(2, x.device)),
                         batches)


def check_against_cpu(models, device, kernels) -> float:
    """The card's path (kernels) against the CPU path (plain versions) on a
    small input with the same full-width weights and draws: 2 classes x 4
    particles x 3 iterations. Returns max |fitness difference|."""
    import copy

    import torch

    from gan_discovery_pso_tpu_torch.core import PsoConfig
    from gan_discovery_pso_tpu_torch.pso import (
        draw_uniforms, make_batched_discovery_runner, swarm_init)

    hp = PsoConfig(n_iterations=3, n_particles=4, dim_space=DIM)
    rng = torch.Generator(device=device).manual_seed(SEED + 4)
    init = swarm_init(rng, 2, 4, DIM, hp.w_inertia, device)
    r1, r2 = draw_uniforms(rng, 3, 2, 4, device)
    _, on_card, _, launches = drive_main_path(models, device, None, kernels, hp, [1, 6],
                                              init_state=init, r1=r1, r2=r2)
    if set(launches.values()) != {3}:
        raise AssertionError(f"small run launches {launches}")
    cpu_models = tuple(copy.deepcopy(m).cpu() for m in models)
    _, on_cpu, _ = make_batched_discovery_runner(hp, eps=EPS, device="cpu")(
        *cpu_models, [1, 6], init_state=type(init)(*(t.cpu() for t in init)),
        r1=r1.cpu(), r2=r2.cpu())
    # fp32 conv sums run in another order in cuDNN and oneDNN
    torch.testing.assert_close(on_card.fitness.cpu(), on_cpu.fitness, rtol=1e-4, atol=1e-5)
    return float((on_card.fitness.cpu() - on_cpu.fitness).abs().max())


def write_checkpoints(models_root: Path, run_id: int, gen=None, cnn=None) -> dict:
    """The models as a JAX run's checkpoints, through the port's writer and
    the inverse weight mapping: `<models>/mnist/{id}--dcgan/best_g.msgpack`
    and `<models>/mnist/{id}--cnn_multipatient/model.msgpack`."""
    from gan_discovery_pso_tpu_torch.compat import generator_tree, resnet_tree
    from gan_discovery_pso_tpu_torch.core.checkpoint import save_pytree

    dirs = {}
    if gen is not None:
        gp, gs = generator_tree(gen.state_dict())
        dirs["gan"] = models_root / "mnist" / f"{run_id:05d}--dcgan"
        save_pytree(dirs["gan"] / "best_g.msgpack",
                    {"epoch": 0, "state": {"gen_params": gp, "gen_state": gs}, "loss": 0.0})
    if cnn is not None:
        rp, rs = resnet_tree(cnn.state_dict())
        dirs["cnn"] = models_root / "mnist" / f"{run_id:05d}--cnn_multipatient"
        save_pytree(dirs["cnn"] / "model.msgpack", {"params": rp, "state": rs})
    return dirs


def check_loaded(original, loaded, what: str) -> None:
    """Every parameter and buffer of the loaded model bit-equal to the
    original's."""
    import torch

    a, b = original.state_dict(), loaded.state_dict()
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: state-dict names differ")
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs after the checkpoint round trip")


def run_cli(tmp: Path, label: str, dirs: dict, device, kernels, *flags, sets=None) -> dict:
    """`pso-discovery` through `cli_stage` on the G and assessor in `dirs`,
    with timing.json, the per-class g_best and trajectories, and the
    artifact seconds the stage logged."""
    run = cli_stage(tmp, label, "pso-discovery", device, kernels, "--path-gan",
                    str(dirs["gan"]), "--path-cnn", str(dirs["cnn"]), *flags, sets=sets)
    with open(run["reports"] / "general" / "overall_history.pkl", "rb") as f:
        history = pickle.load(f)
    trajectories = {}
    for npz in run["interim"].glob("particles_iid_class_*.npz"):
        with np.load(npz) as z:
            trajectories[npz.stem.rsplit("_", 1)[-1]] = (z["positions"], z["velocities"])
    return {**run, "label": label, "trajectories": trajectories,
            "g_best": {k[len("class_"):]: v["global_best_val"][-1] for k, v in history.items()},
            "timing": json.loads((run["reports"] / "timing.json").read_text()),
            "artifact_s": log_seconds(run["log"], r"artifacts written in ([0-9.]+)s")}


def expected_artifacts(run: dict, classes, dim: int, n_iterations: int) -> dict:
    """{package: files the stage writes only where the package is importable}
    and {None: files it always writes}."""
    r, i = run["reports"], run["interim"]
    files = {None: [r / "timing.json", r / "configuration.yaml", r / "log.txt",
                    r / "general" / "timing.pkl", r / "general" / "overall_history.pkl",
                    r / "general" / "overall_history.json"],
             "pandas": [], "matplotlib": [], "PIL": []}
    for c in classes:
        gen_dir, plot_dir = r / "general" / str(c), r / "training_plot" / str(c)
        files[None].append(i / f"particles_iid_class_{c}.npz")
        files["pandas"] += [i / f"particles_position_iid_class_{c}.pkl",
                            i / f"particles_position_iic_class_{c}.pkl",
                            i / f"particles_velocity_iid_class_{c}.pkl"]
        files["matplotlib"] += [gen_dir / "pso_iter.png", gen_dir / "mean_mse.png",
                                plot_dir / "pso_dim_last_iteration.png"]
        files["matplotlib"] += [plot_dir / f"pso_dim_{d}.png" for d in range(dim)]
        files["PIL"] += [plot_dir / f"pso_images_{it}.png" for it in range(1, n_iterations + 1)]
        files["PIL"].append(plot_dir / "iid_img.gif")
        if dim == 2:
            files[None] += [gen_dir / "fitness_grid.pkl", gen_dir / "img_grid.pkl"]
            files["matplotlib"] += [plot_dir / f"2d_plot_{it}.png" for it in range(n_iterations)]
            files["matplotlib"].append(plot_dir / "2dspace_latent.gif")
    return files


def check_artifacts(run: dict, classes, dim: int, n_iterations: int) -> list:
    """Every file of the contract the host can write is there, none of a
    family whose package is missing; returns the skipped packages."""
    import importlib.util

    skipped = []
    for package, files in expected_artifacts(run, classes, dim, n_iterations).items():
        writable = package is None or importlib.util.find_spec(package) is not None
        if not writable:
            skipped.append(package)
        wrong = [str(f) for f in files if f.exists() != writable]
        if wrong:
            raise AssertionError(f"pipeline {run['label']}: {len(wrong)} artifacts "
                                 f"{'missing' if writable else 'written without ' + package}"
                                 f", e.g. {wrong[:3]}")
    return skipped


def check_g_best(run: dict, n_classes: int) -> np.ndarray:
    g = np.asarray([float(v) for v in run["g_best"].values()])
    if len(g) != n_classes or not (np.isfinite(g).all() and (g >= EPS).all()
                                   and (g <= 1 + EPS).all()):
        raise AssertionError(f"pipeline {run['label']}: g_best out of [eps, 1+eps]: {g}")
    return g


def expect_launches(run: dict, want: dict) -> None:
    if run["launches"] != want:
        raise AssertionError(f"pipeline {run['label']}: launches {run['launches']}, "
                             f"not {want}")


def direct_runner(models, device, cfg_sets) -> tuple:
    """The batched runner called directly on the stage's per-class draws
    (KeyChain(seed).child(f"class_{c}")("pso"), drawn per class and stacked):
    (per-class SwarmResults, seconds)."""
    import torch

    from gan_discovery_pso_tpu_torch.core import PsoConfig, load_config
    from gan_discovery_pso_tpu_torch.core.prng import KeyChain
    from gan_discovery_pso_tpu_torch.pso import (
        SwarmResult, draw_uniforms, make_batched_discovery_runner, state_from_positions,
        swarm_init)

    cfg = load_config(CFG, overrides=cfg_sets)
    hp = PsoConfig.from_config(cfg.trainer_pso)
    classes = list(cfg.data.iid_classes)
    keys = KeyChain(int(cfg.seed))
    pos, vel, r1, r2 = [], [], [], []
    for c in classes:
        g = keys.child(f"class_{c}")("pso", device)
        init = swarm_init(g, 1, hp.n_particles, hp.dim_space, hp.w_inertia, device)
        a, b = draw_uniforms(g, hp.n_iterations, 1, hp.n_particles, device)
        pos.append(init.positions[0])
        vel.append(init.velocities[0])
        r1.append(a[:, 0])
        r2.append(b[:, 0])
    init = state_from_positions(torch.stack(pos), torch.stack(vel), hp.w_inertia)
    run = make_batched_discovery_runner(hp, eps=EPS, device=device)
    idxs = [sorted(classes).index(c) for c in classes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist, first = run(*models, idxs, init_state=init, r1=torch.stack(r1, dim=1),
                             r2=torch.stack(r2, dim=1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    batch = SwarmResult(final, hist, first, hp)
    return {str(c): batch.swarm(i) for i, c in enumerate(classes)}, seconds


def pipeline_phase(models, device, kernels, card: str, after_step=None,
                   keep_interim: Path | None = None, keep_dim2: Path | None = None,
                   keep_g_best: dict | None = None) -> dict:
    """The pso-discovery stage through its CLI on JAX-format checkpoints of
    the seeded full-width models: batched fp32 (bit-equal to the runner
    called directly), sequential (B = 1 per class), the shipped dimension 2
    with its landscape, and bf16. Returns each run's launches.
    `after_step(name)`, where given, is called after each step; the batched
    fp32 run's interim dir is copied to `keep_interim` and the dimension-2
    run's to `keep_dim2`, and the sequential run's g_best per class put into
    `keep_g_best`, where given."""
    import shutil
    import tempfile

    import torch

    from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, dcgan_init_
    from gan_discovery_pso_tpu_torch.pipelines import assessor_factory, load_cnn, load_gan
    from gan_discovery_pso_tpu_torch.core import load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig

    sets100 = {"trainer_gan.z_dim": DIM, "trainer_pso.dim_space": DIM}
    cfg = load_config(CFG, overrides=sets100)
    data_cfg = DataConfig.from_config(cfg.data)
    classes = list(data_cfg.iid_classes)
    hp_iters, n_particles = int(cfg.trainer_pso.n_iterations), int(cfg.trainer_pso.n_particles)
    evals = len(classes) * n_particles * hp_iters
    names = [k.__name__ for k in kernels]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_name:
        tmp = Path(tmp_name)
        # 1. JAX-format checkpoints, read back bit for bit
        dirs = write_checkpoints(tmp / "upstream", 1, *models)
        rdef = assessor_factory(cfg, data_cfg, len(classes))[0]
        check_loaded(models[0], load_gan(dirs["gan"], device=device), "generator z=100")
        check_loaded(models[1], load_cnn(dirs["cnn"], rdef, device=device), "ResNet-50")
        rng = torch.Generator(device=device).manual_seed(SEED + 5)
        gen2 = dcgan_init_(Generator(GeneratorDef(2, 1, 64), device=device), rng).eval()
        dirs2 = {**write_checkpoints(tmp / "upstream", 2, gen=gen2), "cnn": dirs["cnn"]}
        check_loaded(gen2, load_gan(dirs2["gan"], device=device), "generator z=2")
        log("pipeline: JAX-format checkpoints (G(64) z=100 and z=2, ResNet-50) "
            "written and read back bit-equal")
        step = after_step or (lambda name: None)
        step("checkpoints")

        # 2. batched fp32 through the CLI, against the runner called directly
        batched = run_cli(tmp, "batched", dirs, device, kernels, "--batch-classes", sets=sets100)
        step("batched CLI run")
        expect_launches(batched, dict.fromkeys(names, hp_iters))
        g32 = check_g_best(batched, len(classes))
        direct, runner_s = direct_runner(models, device, sets100)
        step("direct runner call")
        for c, res in direct.items():
            pos, vel = batched["trajectories"][c]
            if not (np.array_equal(pos, res.particle_trajectories())
                    and np.array_equal(vel, res.velocity_trajectories())
                    and np.float32(batched["g_best"][c]) == res.g_best_val.numpy()[0]):
                raise AssertionError(f"pipeline batched: class {c} differs from the runner")
        skipped = check_artifacts(batched, classes, DIM, hp_iters)
        if keep_interim is not None:
            shutil.copytree(batched["interim"], keep_interim)

        # 3. sequential, one B = 1 runner per class
        seq = run_cli(tmp, "sequential", dirs, device, kernels, sets=sets100)
        step("sequential CLI run")
        expect_launches(seq, dict.fromkeys(names, len(classes) * hp_iters))
        seq_diff = float(np.abs(check_g_best(seq, len(classes)) - g32).max())
        if seq_diff > SEQ_TOL:
            raise AssertionError(f"pipeline sequential: |g_best - batched| {seq_diff} > {SEQ_TOL}")
        check_artifacts(seq, classes, DIM, hp_iters)
        if keep_g_best is not None:
            keep_g_best.update(seq["g_best"])

        # 4. the shipped dimension, z = dim_space = 2, with the landscape
        dim2 = run_cli(tmp, "dim2", dirs2, device, kernels, "--batch-classes",
                       sets={"trainer_gan.z_dim": 2, "trainer_pso.dim_space": 2})
        step("dim 2 CLI run")
        expect_launches(dim2, {"swarm_update": hp_iters,
                               "rescale01_rows": hp_iters + len(classes)})
        check_g_best(dim2, len(classes))
        check_artifacts(dim2, classes, 2, hp_iters)
        if keep_dim2 is not None:
            shutil.copytree(dim2["interim"], keep_dim2)
        for c in classes:
            if dim2["trajectories"][str(c)][0].shape != (hp_iters + 1, n_particles, 2):
                raise AssertionError(f"pipeline dim2: class {c} trajectory "
                                     f"{dim2['trajectories'][str(c)][0].shape}")
            with open(dim2["reports"] / "general" / str(c) / "fitness_grid.pkl", "rb") as f:
                grid = pickle.load(f)
            if grid.shape != (LANDSCAPE, LANDSCAPE) or not (
                    np.isfinite(grid).all() and (grid >= EPS).all() and (grid <= 1 + EPS).all()):
                raise AssertionError(f"pipeline dim2: class {c} fitness_grid {grid.shape} "
                                     f"in [{grid.min()}, {grid.max()}]")

        # 5. bf16 on step 2's setup: the gate
        bf16 = run_cli(tmp, "bf16", dirs, device, kernels, "--batch-classes", "--fast-math",
                       sets=sets100)
        step("bf16 CLI run")
        expect_launches(bf16, dict.fromkeys(names, hp_iters))
        gate = float(np.abs(check_g_best(bf16, len(classes)) - g32).max())
        if gate > GATE:
            raise AssertionError(f"pipeline bf16 gate: max |g32 - g16| = {gate} > {GATE}")

    log(f"pipeline: batched CLI run bit-equal to the runner (trajectories, velocities, "
        f"g_best of {len(classes)} classes); sequential within {seq_diff:.3e} of batched "
        f"(<= {SEQ_TOL}); bf16 gate {gate:.3e} (<= {GATE}); dim 2 landscapes "
        f"[{LANDSCAPE},{LANDSCAPE}] in [eps, 1+eps]")
    log(f"pipeline: host packages missing, families not written: {skipped or 'none'}")
    log(f"pipeline runner alone (batched fp32, direct call): {runner_s:.6f} s, "
        f"{evals / runner_s:.0f} evals/s ({card})")
    for run in (batched, seq, dim2, bf16):
        t = run["timing"]
        runner_in_stage = t.get("training_time_all_classes") or max(
            v for k, v in t.items() if k.startswith("training_time_class_"))
        log(f"pipeline {run['label']}: stage {run['wall']:.6f} s (cli.main), runner in stage "
            f"{runner_in_stage:.6f} s, {evals / runner_in_stage:.0f} evals/s, artifacts "
            f"{run['artifact_s']:.6f} s; launches {run['launches']} ({card})")
        out[run["label"]] = run["launches"]
    return out


def write_encoder(models_root: Path, run_id: int, device) -> tuple:
    """A seeded plain encoder (DCGAN init, f=64, z=DIM) as a JAX inverter
    run's `<models>/mnist/{id}--inverter/encoder.msgpack`: (encoder, dir)."""
    import torch

    from gan_discovery_pso_tpu_torch.compat import encoder_tree
    from gan_discovery_pso_tpu_torch.core.checkpoint import save_pytree
    from gan_discovery_pso_tpu_torch.models import Encoder, EncoderDef, dcgan_init_

    rng = torch.Generator(device=device).manual_seed(SEED + 6)
    enc = dcgan_init_(Encoder(EncoderDef(DIM, 1, 64), device=device), rng).eval()
    d = models_root / "mnist" / f"{run_id:05d}--inverter"
    save_pytree(d / "encoder.msgpack", {"params": encoder_tree(enc.state_dict())})
    return enc, d


def stage_numbers(reports: Path) -> dict:
    """The seconds of a pso-inverter run: the swarm's (its `timing.json`
    key), and from its log phase 1 (where it fine-tuned, the data load and
    the training) and the artifacts."""
    import re

    lines = (reports / "log.txt").read_text().splitlines()
    found = lambda prefix: [ln for ln in lines if ln.startswith(prefix)]  # noqa: E731
    line = found("[pso_inverter] patient")[-1]
    grab = lambda pattern, text=line: float(re.search(pattern, text).group(1))  # noqa: E731
    timing = json.loads((reports / "timing.json").read_text())
    out = {"phase1_s": grab(r"phase 1 \([a-z-]+\) ([0-9.]+)s"),
           "runner_s": timing[f"pso_inverter_time_ood_patient_{PATIENT}"],
           "artifact_s": grab(r"written in ([0-9.]+)s")}
    for tuned in found("[pso_inverter] fine-tune:"):
        out.update(data_s=grab(r"data ([0-9.]+)s", tuned), train_s=grab(r"epochs ([0-9.]+)s", tuned))
    return out


def check_inverter_g_best(g, what: str) -> float:
    g = float(g)
    if not (np.isfinite(g) and 2 * EPS <= g <= 1 + 2 * EPS + 4):
        raise AssertionError(f"inverter {what}: g_best {g} out of [2 eps, 1 + 2 eps + 4]")
    return g


def same_swarm(a, b, what: str) -> None:
    """Two B = 1 SwarmResults bit-equal: trajectories, velocities, g_best."""
    if not (np.array_equal(a.particle_trajectories(), b.particle_trajectories())
            and np.array_equal(a.velocity_trajectories(), b.velocity_trajectories())
            and np.array_equal(a.g_best_val.numpy(), b.g_best_val.numpy())):
        raise AssertionError(f"inverter: {what} differs from the CLI run")


def inverter_phase(models, device, kernels, card: str, sets=(),
                   keep_interim: Path | None = None) -> dict:
    """The pso-inverter stage on JAX-format checkpoints: through its CLI
    (1-epoch fine-tune, 256 particles x 50 iterations, fp32), again on a
    run dir that holds the fine-tuned assessor (the try-load branch), the
    runner called directly on the stage's draws, and bf16 on the try-load
    branch. Returns each run's launches. `sets` adds config overrides (a
    rehearsal on the CPU cuts the sizes); the CLI run's interim dir (the
    patient's OoD particles) is copied to `keep_interim`, where given."""
    import copy
    import shutil
    import tempfile

    import torch

    from gan_discovery_pso_tpu_torch.core import load_config
    from gan_discovery_pso_tpu_torch.core.config import AdamConfig, DataConfig
    from gan_discovery_pso_tpu_torch.core.prng import KeyChain
    from gan_discovery_pso_tpu_torch.models import ResNetDef
    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.pipelines import (
        StageContext, assessor_factory, load_cnn, load_encoder, load_gan, run_pso_inverter)
    from gan_discovery_pso_tpu_torch.pso import (
        SwarmResult, draw_uniforms, make_inverter_runner, swarm_init_from_positions)

    names = [k.__name__ for k in kernels]
    counts = lambda: {k.__name__: k.launches for k in kernels}  # noqa: E731
    zero = lambda: zero_counts(kernels)  # noqa: E731
    out, timings = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inv_") as tmp_name:
        tmp = Path(tmp_name)
        # 1. JAX-format checkpoints, read back bit for bit
        dirs = write_checkpoints(tmp / "upstream", 1, *models)
        enc, dirs["inv"] = write_encoder(tmp / "upstream", 1, device)
        overrides = {"trainer_gan.z_dim": DIM, "data.data_dir": str(tmp / "no_mnist"),
                     **{f"data.{k}_dir": str(tmp / "runs" / k)
                        for k in ("reports", "model", "interim")}, **dict(sets)}
        cfg = load_config(CFG, overrides=overrides)
        data_cfg = DataConfig.from_config(cfg.data)
        iid = tuple(data_cfg.iid_classes)
        rdef = assessor_factory(cfg, data_cfg, len(iid))[0]
        check_loaded(enc, load_encoder(dirs["inv"], device=device), "encoder f=64 z=100")
        check_loaded(models[0], load_gan(dirs["gan"], device=device), "generator z=100")
        check_loaded(models[1], load_cnn(dirs["cnn"], rdef, device=device), "ResNet-50")
        log("inverter: JAX-format checkpoints (encoder f=64 z=100, G(64) z=100, "
            "ResNet-50) written and read back bit-equal")

        # 2. the CLI on a fresh run dir: phase 1 fine-tunes; the stage's
        # return value is kept to hold model_1.msgpack against it
        cli = cli_stage(tmp, "runs", "pso-inverter", device, kernels, "--epochs", "1",
                        "--ood-patient", str(PATIENT), "--path-gan", str(dirs["gan"]),
                        "--path-cnn", str(dirs["cnn"]), "--path-inverter", str(dirs["inv"]),
                        sets=overrides, keep="run_pso_inverter")
        out["inverter_cli"], wall = cli["launches"], cli["wall"]
        res, fine = cli["value"]
        n_iters, n = res.hp.n_iterations, res.hp.n_particles
        if out["inverter_cli"] != dict.fromkeys(names, n_iters):
            raise AssertionError(f"inverter CLI launches {out['inverter_cli']}, not {n_iters} each")
        reports, models_dir = cli["reports"], cli["model"]
        if keep_interim is not None:
            shutil.copytree(cli["interim"], keep_interim)
        g32 = check_inverter_g_best(res.g_best_val[0], "CLI")
        with open(reports / "general" / "overall_history.pkl", "rb") as f:
            history = pickle.load(f)
        cnn_hist = history[f"cnn_history_ood_patient_{PATIENT}"]
        if not all(np.isfinite(v).all() and len(v) == 1 for v in cnn_hist.values()):
            raise AssertionError(f"inverter fine-tune history {cnn_hist}")
        bdef = ResNetDef(rdef.model_name, rdef.image_channels, 2, iid + (PATIENT,))
        check_loaded(fine, load_cnn(models_dir, bdef, label=PATIENT, device=device),
                     f"model_{PATIENT}.msgpack")
        timings["cli"] = {"stage_s": wall, **stage_numbers(reports)}
        log(f"inverter CLI: {n} particles x {n_iters} iterations, g_best {g32:.6f}; "
            f"fine-tune history {json.dumps(cnn_hist)}; model_{PATIENT}.msgpack read back "
            "bit-equal to the stage's assessor")

        # 3. the try-load branch: a new run dir holding that model_1.msgpack
        def try_load_ctx():
            ctx = StageContext.create(CFG, "pso_inverter", overrides=overrides, device=device)
            shutil.copy(models_dir / f"model_{PATIENT}.msgpack", ctx.run.models_dir)
            return ctx

        gen = load_gan(dirs["gan"], device=device)
        cnn = load_cnn(dirs["cnn"], rdef, device=device)
        enc = load_encoder(dirs["inv"], device=device)
        ctx = try_load_ctx()
        zero()
        t0 = time.perf_counter()
        with ctx.tee():
            again, _ = run_pso_inverter(ctx, gen, enc, cnn, rdef, ood_patient=PATIENT)
        torch.cuda.synchronize()
        out["inverter_try_load"] = counts()
        timings["try_load"] = {"stage_s": time.perf_counter() - t0,
                               **stage_numbers(ctx.run.reports_dir)}
        same_swarm(again, res, "the try-load rerun")

        # 4. the runner alone, on the stage's slices, positions and draws
        ood = ctx.dataset("train", classes=(PATIENT,), drange=(-1, 1))
        slices = ood.images[:n]
        with fp32_parity(), torch.inference_mode():  # as the stage encodes
            pos = enc(slices).reshape(n, -1)
        g = KeyChain(int(cfg.seed))("pso", device)  # the stage's draw
        init = swarm_init_from_positions(g, pos[None].clone(), res.hp.w_inertia)
        r1, r2 = draw_uniforms(g, n_iters, 1, n, device)
        run = make_inverter_runner(res.hp, device=device)
        zero()
        t0 = time.perf_counter()
        final, hist, first = run(gen, fine, 1, slices, None, init_state=init, r1=r1, r2=r2)
        torch.cuda.synchronize()
        runner_s = time.perf_counter() - t0
        out["inverter_runner"] = counts()
        same_swarm(SwarmResult(final, hist, first, res.hp).swarm(0), res, "the runner alone")

        # 5. the encoder on the card against the CPU
        small = slices[:16]
        with fp32_parity(), torch.inference_mode():
            on_card = enc(small).cpu()
            on_cpu = copy.deepcopy(enc).cpu()(small.cpu())
        torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-5)
        enc_diff = float((on_card - on_cpu).abs().max())

        # 6. bf16 forwards on the try-load branch: recorded, not gated
        ctx = try_load_ctx()
        zero()
        with ctx.tee():
            bf16, _ = run_pso_inverter(ctx, gen, enc, cnn, rdef, ood_patient=PATIENT,
                                       fast_math_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out["inverter_bf16"] = counts()
        bf16_diff = abs(check_inverter_g_best(bf16.g_best_val[0], "bf16") - g32)
        timings["bf16"] = stage_numbers(ctx.run.reports_dir)

        # 7. where the fine-tune's time goes: a few of its steps profiled
        tune = profile_fine_tune(fine, ctx.dataset("train", classes=bdef.iid_classes,
                                                   drange=(0, 1)),
                                 AdamConfig.from_config(cfg.trainer_pso_inverter.optimizer))
    for label, launches in out.items():
        if launches != dict.fromkeys(names, n_iters):
            raise AssertionError(f"{label}: launches {launches}, not {n_iters} each")

    evals = n * n_iters
    log(f"inverter: try-load rerun and runner alone bit-equal to the CLI run "
        f"(trajectories, velocities, g_best); encoder card vs CPU {enc_diff:.3e} (rtol 1e-4); "
        f"|g_best fp32 - bf16| {bf16_diff:.3e} (not gated)")
    for label, t in timings.items():
        stage = f"stage {t['stage_s']:.6f} s, " if "stage_s" in t else ""
        tuned = (f" (data {t['data_s']:.6f} s, training {t['train_s']:.6f} s)"
                 if "train_s" in t else "")
        log(f"inverter {label}: {stage}phase 1 {t['phase1_s']:.6f} s{tuned}, runner in stage "
            f"{t['runner_s']:.6f} s ({evals / t['runner_s']:.0f} evals/s), artifacts "
            f"{t['artifact_s']:.6f} s ({card})")
    log(f"inverter runner alone (fp32, direct call): {runner_s:.6f} s, "
        f"{evals / runner_s:.0f} evals/s ({card})")
    log(f"inverter fine-tune steps profiled ({card}): " + json.dumps(tune))
    return out


def training_nets(device, models):
    """(G, E, D, ResNet-50) at full width for the step checks, built on the
    CPU from one seeded generator and moved to `device`: G and E with
    torch's default init (a DCGAN-init G's images are flat in z, which
    leaves E's gradients at rounding level), D with the DCGAN init, the
    main path's ResNet-50."""
    import copy

    import torch

    from gan_discovery_pso_tpu_torch.models import (
        Discriminator, DiscriminatorDef, Encoder, EncoderDef, Generator, GeneratorDef,
        dcgan_init_, torch_default_init_)

    rng = torch.Generator().manual_seed(SEED + 7)
    gen = torch_default_init_(Generator(GeneratorDef(DIM, 1, 64)), rng).eval()
    enc = torch_default_init_(Encoder(EncoderDef(DIM, 1, 64)), rng)
    disc = dcgan_init_(Discriminator(DiscriminatorDef(1, 64)), rng)
    return tuple(m.to(device) for m in (gen, enc, disc, copy.deepcopy(models[1])))


def step_results(nets, device, x, labels, adam, adam_d) -> dict:
    """On `device`, from copies of `nets`: one pix_rec step, one
    pix_fea_rec_adv step (R1 included) fed `labels`, and 10 invert
    iterations, in fp32 parity; the losses, the updated weights and z on
    the host."""
    import copy

    import torch

    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.train.inverter import (
        invert, make_pix_fea_rec_adv_step, make_pix_rec_step)

    gen, enc, disc, cnn = (copy.deepcopy(m).to(device) for m in nets)
    x = x.to(device)
    host = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    out = {}
    with fp32_parity():
        e = copy.deepcopy(enc)
        step, _ = make_pix_rec_step(gen, e, adam)
        out["pix_rec"] = {"loss": step(x).cpu()}
        out["pix_rec_E"] = host(e.state_dict())
        e, d = copy.deepcopy(enc), copy.deepcopy(disc)
        step, _ = make_pix_fea_rec_adv_step(gen, e, d, cnn, adam, adam_d)
        out["adv"] = {k: v.cpu() for k, v in step(x, tuple(t.to(device) for t in labels)).items()}
        out["adv_E"], out["adv_D"] = host(e.state_dict()), host(d.state_dict())
        z, hist = invert(x[:8], gen, enc, iterations=9)
        out["invert_z"], out["invert_hist"] = z.cpu(), hist
    return out


def compare_card_cpu(card: dict, cpu: dict) -> dict:
    """Card against CPU: losses rtol 1e-4 (cuDNN and oneDNN sum fp32 convs
    in other orders, as for the encoder); updated weights within 2e-6 at all
    but 1 in 10^4 entries (Adam's first step is ±lr by the gradient's sign,
    which flips where a gradient is at rounding level); invert's z rtol 1e-4
    atol 1e-5 and its history rtol 1e-4. Returns the largest differences."""
    import numpy as np
    import torch

    diffs = {}
    for what in ("pix_rec", "adv"):
        for k, v in card[what].items():
            torch.testing.assert_close(v, cpu[what][k], rtol=1e-4, atol=1e-9, msg=f"{what} {k}")
            diffs[f"{what}.{k}"] = float((v - cpu[what][k]).abs() / cpu[what][k].abs().clamp_min(1e-30))
    for what in ("pix_rec_E", "adv_E", "adv_D"):
        n = off = 0
        worst = 0.0
        for k, v in card[what].items():
            d = (v.float() - cpu[what][k].float()).abs()
            n, off, worst = n + d.numel(), off + int((d > 2e-6).sum()), max(worst, float(d.max()))
        if off * 10 ** 4 > n:
            raise AssertionError(f"card vs CPU: {what}: {off} of {n} entries differ by > 2e-6")
        diffs[what] = {"max_abs": worst, "entries_over_2e-6": off, "entries": n}
    torch.testing.assert_close(card["invert_z"], cpu["invert_z"], rtol=1e-4, atol=1e-5)
    for k, v in card["invert_hist"].items():
        np.testing.assert_allclose(v, cpu["invert_hist"][k], rtol=1e-4, err_msg=k)
    diffs["invert_z_max_abs"] = float((card["invert_z"] - cpu["invert_z"]).abs().max())
    return diffs


def inverter_training_phase(models, device, kernels, card: str, pso_interim: Path,
                            sets=(), flags=()) -> dict:
    """The inverter and the two regularize stages through the CLI on
    JAX-format checkpoints of the seeded full-width G and ResNet-50, on the
    synthetic digits: a 1-epoch pix_fea_rec_adv run (finite losses, its
    `encoder.msgpack` read back bit-equal), 1-epoch pix_rec runs with the
    plain and the AttGAN encoder (the AttGAN checkpoint refused by
    `load_encoder`), 5 steady steps of each kind profiled, regularize-
    inverter on the adversarial run's encoder (8 OoD images, 500
    iterations: the loss falls, the artifacts, a bit-equal rerun; 20
    inversion steps profiled) and regularize-inverter-statistics on
    `pso_interim` (the pipeline phase's
    batched fp32 particles), then one step of each kind and 10 invert
    iterations on the card against the CPU. No port kernel runs here: every
    run must count 0 launches. Returns each run's launches. `sets` and
    `flags` add config overrides and CLI flags (a rehearsal on the CPU cuts
    the data)."""
    import copy
    import tempfile

    import torch

    from gan_discovery_pso_tpu_torch import pipelines
    from gan_discovery_pso_tpu_torch.analysis.reporting import host_has
    from gan_discovery_pso_tpu_torch.compat import encoder_attgan_state_dict, to_tensors
    from gan_discovery_pso_tpu_torch.core import AdamConfig, load_config
    from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, restore_tree
    from gan_discovery_pso_tpu_torch.data import load_mnist
    from gan_discovery_pso_tpu_torch.models import (
        Discriminator, DiscriminatorDef, EncoderAttGAN, EncoderAttGANDef, dcgan_init_)
    from gan_discovery_pso_tpu_torch.train.inverter import (
        invert, make_pix_fea_rec_adv_step, make_pix_rec_step)

    t_phase = time.perf_counter()
    out, report = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_invtrain_") as tmp_name:
        tmp = Path(tmp_name)
        dirs = write_checkpoints(tmp / "upstream", 1, *models)
        overrides = {"trainer_gan.z_dim": DIM, "data.data_dir": str(tmp / "no_mnist"),
                     **dict(sets)}
        gan = ["--path-gan", str(dirs["gan"])]

        def run(label: str, stage: str, *args, **extra) -> dict:
            r = cli_stage(tmp, label, stage, device, kernels, *flags, *args,
                          sets={**overrides, **extra}, keep="run_inverter")
            out[label] = r["launches"]
            if any(r["launches"].values()):
                raise AssertionError(f"{label}: launches {r['launches']}; no port kernel is on "
                                     "this stage's path")
            with open(r["reports"] / "general" / "overall_history.pkl", "rb") as f:
                history = pickle.load(f)
            bad = {k: v for k, v in history.items() if not np.isfinite(v).all()}
            if bad:
                raise AssertionError(f"{label}: losses not finite: {bad}")
            return {**r, "history": history, "encoder": r["value"] and r["value"][0]}

        def epoch_numbers(r: dict) -> dict:
            return {"stage_s": r["wall"],
                    "data_s": log_seconds(r["log"], r"\[inverter\] data ([0-9.]+)s"),
                    "train_steps": int(log_seconds(r["log"], r"epoch 0: ([0-9]+) train steps")),
                    "train_s": log_seconds(r["log"], r"train steps ([0-9.]+)s"),
                    "eval_s": log_seconds(r["log"], r", eval ([0-9.]+)s"),
                    "visuals_s": log_seconds(r["log"], r"visuals ([0-9.]+)s")}

        # 1. the adversarial inverter, 1 epoch
        adv = run("inverter_adv", "inverter", "--epochs", "1", *gan, "--path-cnn",
                  str(dirs["cnn"]), **{"trainer_inverter.training_function": "pix_fea_rec_adv"})
        check_loaded(adv["encoder"], pipelines.load_encoder(adv["model"], device=device),
                     "encoder.msgpack (pix_fea_rec_adv)")
        report["pix_fea_rec_adv"] = {**epoch_numbers(adv), "history": adv["history"]}

        # 2. pix_rec with the plain and the AttGAN encoder, 1 epoch each
        plain = run("inverter_pix_rec", "inverter", "--epochs", "1", *gan)
        check_loaded(plain["encoder"], pipelines.load_encoder(plain["model"], device=device),
                     "encoder.msgpack (pix_rec)")
        report["pix_rec"] = {**epoch_numbers(plain), "history": plain["history"]}
        attgan = run("inverter_attgan", "inverter", "--epochs", "1", *gan,
                     **{"model_inverter.encoder_variant": "attgan"})
        saved = restore_tree(load_pytree(attgan["model"] / "encoder.msgpack"))
        if saved.get("variant") not in ("attgan", b"attgan"):
            raise AssertionError(f"AttGAN checkpoint variant {saved.get('variant')!r}")
        built = EncoderAttGAN(EncoderAttGANDef(DIM), device=device)
        built.load_state_dict(to_tensors(encoder_attgan_state_dict(
            saved["params"], saved["state"]), device=device))
        check_loaded(attgan["encoder"], built, "encoder.msgpack (AttGAN)")
        try:
            pipelines.load_encoder(attgan["model"], device=device)
            raise AssertionError("load_encoder read an AttGAN checkpoint")
        except ValueError as e:
            if "AttGAN" not in str(e):
                raise
        report["attgan_pix_rec"] = {**epoch_numbers(attgan), "history": attgan["history"]}
        log(f"inverter training: 1-epoch runs, losses finite, each encoder.msgpack read "
            f"back bit-equal, the AttGAN one refused by load_encoder ({card}): "
            + json.dumps(report))

        # 3. where a step's time goes: 5 steady steps of each kind profiled
        cfg = load_config(CFG, overrides=overrides)
        adam = AdamConfig.from_config(cfg.trainer_inverter.encoder_optimizer)
        adam_d = AdamConfig.from_config(cfg.trainer_inverter.discriminator_optimizer)
        bs = int(cfg.trainer_inverter.batch_size)
        iid = load_mnist(tmp / "no_mnist", "train", classes=tuple(cfg.data.iid_classes),
                         drange=(-1, 1), device=device).images
        batches = [iid[i * bs:(i + 1) * bs] for i in range(7)]
        rng = torch.Generator().manual_seed(SEED + 8)
        draws = [(0.7 + 0.5 * torch.rand(bs, generator=rng), 0.3 * torch.rand(bs, generator=rng))
                 for _ in batches]
        disc = dcgan_init_(Discriminator(DiscriminatorDef(1, 64)),
                           torch.Generator().manual_seed(SEED + 9)).to(device)
        gen, cnn = models
        step, _ = make_pix_fea_rec_adv_step(gen, copy.deepcopy(adv["encoder"]), disc, cnn,
                                            adam, adam_d)
        prof_adv = profile_steps(step, [(x, tuple(t.to(device) for t in d))
                                        for x, d in zip(batches, draws)])
        step, _ = make_pix_rec_step(gen, copy.deepcopy(plain["encoder"]), adam)
        prof_rec = profile_steps(step, [(x,) for x in batches])
        log(f"inverter pix_fea_rec_adv steps profiled (batch {bs}, {card}): "
            + json.dumps(prof_adv))
        log(f"inverter pix_rec steps profiled (batch {bs}, {card}): " + json.dumps(prof_rec))

        # 4. regularize-inverter on the adversarial run's encoder, and again
        enc_dir = ["--path-inverter", str(adv["model"])]
        reg = run("regularize", "regularize-inverter", *gan, *enc_dir)
        again = run("regularize_rerun", "regularize-inverter", *gan, *enc_dir)
        loss = reg["history"]["loss"]
        if not loss[-1] < loss[0] or len(loss) != 501:
            raise AssertionError(f"regularize-inverter: {len(loss)} steps, loss {loss[0]} -> "
                                 f"{loss[-1]}")
        files = [reg["interim"] / "inverted_z.npz"]
        if host_has("pandas"):
            files.append(reg["interim"] / "particles_position_ood.pkl")
        if host_has("PIL"):
            files += [reg["reports"] / "general" / f"{n}.png" for n in ("ori", "enc", "inv")]
        missing = [str(f) for f in files if not f.exists()]
        if missing:
            raise AssertionError(f"regularize-inverter: missing {missing}")
        with np.load(reg["interim"] / "inverted_z.npz") as a, \
                np.load(again["interim"] / "inverted_z.npz") as b:
            if a["z"].shape != (8, DIM, 1, 1) or not np.array_equal(a["z"], b["z"]):
                raise AssertionError("regularize-inverter: the rerun's z differs")
        if not all(np.array_equal(v, again["history"][k]) for k, v in reg["history"].items()):
            raise AssertionError("regularize-inverter: the rerun's history differs")
        report_reg = {"stage_s": [reg["wall"], again["wall"]],
                      "it_per_s": [log_seconds(r["log"], r"\(([0-9.]+) it/s\)")
                                   for r in (reg, again)],
                      "loss": [float(loss[0]), float(loss[-1])]}
        # where an inversion step's time goes: 20 steps of the stage's call
        # under the profiler, after two warm-up calls
        ood = load_mnist(tmp / "no_mnist", "test", classes=tuple(cfg.data.ood_classes),
                         drange=(-1, 1), device=device).images[:8]
        enc = pipelines.load_encoder(adv["model"], device=device)
        prof_inv = profile_steps(lambda x: invert(x, gen, enc, iterations=19), [(ood,)] * 3)
        log(f"invert steps profiled (8 images x 20 steps in one call, {card}): "
            + json.dumps(prof_inv))

        # 5. regularize-inverter-statistics on the pipeline phase's particles
        stats = run("statistics", "regularize-inverter-statistics", *gan, *enc_dir,
                    "--path-pso", str(pso_interim))
        with np.load(stats["interim"] / "inverted_bn_z.npz") as a:
            w = a["weights"]
            if a["z"].shape != (8, DIM, 1, 1) or w.shape != (8, len(cfg.data.iid_classes)):
                raise AssertionError(f"statistics: z {a['z'].shape}, w {w.shape}")
        sloss = stats["history"]["loss"]
        report_stats = {"stage_s": stats["wall"],
                        "it_per_s": log_seconds(stats["log"], r"\(([0-9.]+) it/s\)"),
                        "loss": [float(sloss[0]), float(sloss[-1])], "w": w.tolist()}
        log(f"regularize-inverter: 8 images x 501 steps, loss falls, artifacts written, the "
            f"rerun bit-equal ({card}): {json.dumps(report_reg)}")
        log(f"regularize-inverter-statistics ({card}): {json.dumps(report_stats)}")

        # 6. one step of each kind and 10 invert iterations, card against CPU
        nets = training_nets(device, models)
        x = iid[:32]
        labels = (0.7 + 0.5 * torch.rand(32, generator=rng), 0.3 * torch.rand(32, generator=rng))
        on_card = step_results(nets, device, x, labels, adam, adam_d)
        on_cpu = step_results(nets, torch.device("cpu"), x, labels, adam, adam_d)
        diffs = compare_card_cpu(on_card, on_cpu)
        log("inverter card vs CPU (batch 32, full width): " + json.dumps(diffs))
    log(f"inverter training phase: {time.perf_counter() - t_phase:.6f} s ({card})")
    return out


def cli_stage(tmp: Path, label: str, stage: str, device, kernels, *args, sets=None,
              keep: str | None = None, cfg: Path = CFG, dataset: str = "mnist") -> dict:
    """`cli.main([stage, "--cfg", cfg, ...])` in this process, its run dirs
    under tmp/label/<dataset>: the wall time, the launches of each kernel
    (counts zeroed just before), the run dirs, the text of its log.txt, and
    what `pipelines.<keep>` returned, where `keep` names the stage
    function. A non-zero return raises."""
    import torch

    from gan_discovery_pso_tpu_torch import pipelines
    from gan_discovery_pso_tpu_torch.cli.main import main as cli_main

    roots = {k: tmp / label / k for k in ("reports", "model", "interim")}
    cfg_sets = {**(sets or {}), **{f"data.{k}_dir": v for k, v in roots.items()}}
    argv = [stage, "--cfg", str(cfg), "--device", str(device), *args, "--set",
            *(f"{k}={v}" for k, v in cfg_sets.items())]
    kept = {}
    real = getattr(pipelines, keep) if keep else None

    def keeping(*a, **kw):
        kept["value"] = real(*a, **kw)
        return kept["value"]

    if keep:
        setattr(pipelines, keep, keeping)
    try:
        zero_counts(kernels)
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if keep:
            setattr(pipelines, keep, real)
    if rc != 0:
        raise AssertionError(f"{label}: the CLI returned {rc}")
    run_dirs = {k: v / dataset / f"00001--{stage.replace('-', '_')}" for k, v in roots.items()}
    return {"wall": wall, "launches": {k.__name__: k.launches for k in kernels},
            "value": kept.get("value"), "log": (run_dirs["reports"] / "log.txt").read_text(),
            **run_dirs}


def near_tie_rows(queries, train_x, k: int, rtol: float = 1e-5):
    """Rows whose k-th and (k+1)-th nearest squared distances lie within
    `rtol` of each other: where rounding may pick another neighbour."""
    import torch

    from gan_discovery_pso_tpu_torch.ops import pairwise_sq_dists

    s = torch.sort(pairwise_sq_dists(queries, train_x), dim=1).values
    return (s[:, k] - s[:, k - 1]).abs() <= rtol * s[:, k].abs()


def posteriors_agree(on_card, on_cpu, ties, what: str) -> dict:
    """Card and CPU posteriors [N, C] equal on every row but near-ties;
    raises where a row that is not a near-tie differs. Returns the counts."""
    import torch

    differ = (on_card.cpu() != on_cpu).any(dim=1)
    ties = ties.cpu()
    if bool((differ & ~ties).any()):
        raise AssertionError(f"{what}: {int((differ & ~ties).sum())} rows that are no near-tie "
                             "differ between the card and the CPU")
    return {"rows": int(differ.numel()), "rows_differing": int(differ.sum()),
            "near_tie_rows": int(ties.sum())}


def evaluation_numbers(res) -> dict:
    return {"fid": float(res.fid), "is": float(res.inception_score),
            "rec": float(res.rec_loss_syn)}


def assessor_eval_phase(models, device, kernels, card: str, sets=(),
                        keep_upstream: Path | None = None) -> dict:
    """The assessor and evaluation stages through the CLI on the synthetic
    digits, at the shipped widths in fp32 parity: `cae` (latent 10, batch
    128, 1 epoch; both files read back bit-equal), `classifiers` on it
    (`classifiers.msgpack` read back; the test split's posterior on the card
    against the CPU path, equal but for near-ties), `cnn-multipatient`
    (ResNet-50, 8 classes, 1 epoch; `model.msgpack` read back bit-equal)
    and `pso-discovery --batch-classes` on that models dir with G(64),
    z = 100, 8 x 32 x 50 (50 launches of each kernel), `cnn` (8 ResNet-50s,
    1 epoch, --limit 2048; each `model_{label}.msgpack` read back), an
    AlexNet `cnn-multipatient` (padding same, 1 epoch) under the batched
    runner (50 launches each), then `evaluate_gan_epoch` with G(64), the
    phase's CAE and battery over N_SYNTHETIC images (B2 10 launches at
    [1280, 784]; FID, IS, rec, wall time, one evaluation profiled) and 1280
    images on the card against the CPU. The stages themselves launch no
    port kernel. Returns each run's launches. `sets` adds config overrides
    (a rehearsal on the CPU cuts the data). The `cae` and `classifiers`
    models dirs are copied to `keep_upstream/{cae,classifiers}`, where
    given."""
    import copy
    import shutil
    import tempfile

    import torch

    from gan_discovery_pso_tpu_torch.core import PsoConfig, load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig
    from gan_discovery_pso_tpu_torch.data import load_mnist
    from gan_discovery_pso_tpu_torch.evaluation import (
        compute_posterior, encode, evaluate_gan_epoch, inception_score, load_battery,
        mean_and_cov)
    from gan_discovery_pso_tpu_torch.evaluation.classifiers import auto_chunk
    from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, ResNetDef
    from gan_discovery_pso_tpu_torch.pipelines import assessor_factory, load_cae, load_cnn
    from gan_discovery_pso_tpu_torch.train.dcgan import make_sampler

    t_phase = time.perf_counter()
    out, report = {}, {}
    names = [k.__name__ for k in kernels]
    none = dict.fromkeys(names, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_assess_") as tmp_name:
        tmp = Path(tmp_name)
        data = {"data.data_dir": str(tmp / "no_mnist"), **dict(sets)}

        def stage(label, name, *args, keep=None, **extra):
            run = cli_stage(tmp, label, name, device, kernels, *args, sets={**data, **extra},
                            keep=keep)
            out[label] = run["launches"]
            tag = f"[{name.replace('-', '_')}]"  # the stage's own lines: its splits
            report[label] = {"stage_s": run["wall"], "log": [
                ln for ln in run["log"].splitlines() if ln.startswith(tag) and "done →" not in ln]}
            return run

        # 1. cae, 1 epoch at the shipped widths; both files read back
        cae = stage("cae", "cae", "--epochs", "1", keep="run_cae")
        encoder, decoder, history = cae["value"]
        enc2, dec2 = load_cae(cae["model"], device=device)
        check_loaded(encoder, enc2, "encoder.msgpack (cae)")
        check_loaded(decoder, dec2, "decoder.msgpack (cae)")
        if not np.isfinite(history["train_loss"]).all():
            raise AssertionError(f"cae: losses not finite: {history}")

        # 2. classifiers on that CAE; the posterior on the card and the CPU
        cls = stage("classifiers", "classifiers", "--path-cae", str(cae["model"]),
                    keep="run_classifiers")
        battery = load_battery(cls["model"] / "classifiers.msgpack", device=device)
        kept = cls["value"]
        for a, b in zip(battery[:3], kept[:3]):
            if not torch.equal(a, b):
                raise AssertionError("classifiers.msgpack differs from the stage's battery")
        cfg = load_config(CFG, overrides=data)
        data_cfg = DataConfig.from_config(cfg.data)
        val = load_mnist(data["data.data_dir"], "test", classes=data_cfg.iid_classes,
                         drange=(0, 1), device=device)
        emb_te = encode(encoder, val.images)
        cpu_battery = type(battery)(*(t.cpu() for t in battery[:3]), k=battery.k)
        report["classifiers_card_vs_cpu"] = posteriors_agree(
            compute_posterior(battery, emb_te), compute_posterior(cpu_battery, emb_te.cpu()),
            near_tie_rows(emb_te, battery.train_x, battery.k), "classifiers posterior")

        # 3. cnn-multipatient (ResNet-50), then pso-discovery on its model.msgpack
        multi = stage("cnn_multipatient", "cnn-multipatient", "--epochs", "1",
                      keep="run_cnn_multipatient")
        model, mdef = multi["value"]
        check_loaded(model, load_cnn(multi["model"], mdef, device=device),
                     "model.msgpack (cnn-multipatient)")
        dirs = {**write_checkpoints(tmp / "upstream", 1, gen=models[0]), "cnn": multi["model"]}
        pso = run_cli(tmp, "pso_on_port_assessor", dirs, device, kernels, "--batch-classes",
                      sets={"trainer_gan.z_dim": DIM, "trainer_pso.dim_space": DIM,
                            **dict(sets)})
        out["pso_on_port_assessor"] = pso["launches"]
        iters = int(cfg.trainer_pso.n_iterations)
        expect_launches(pso, dict.fromkeys(names, iters))
        report["pso_on_port_assessor"] = {"stage_s": pso["wall"],
                                          "g_best": check_g_best(pso, len(mdef.iid_classes))
                                          .tolist()}

        # 4. cnn: the one-vs-all battery of 8 ResNet-50s, cut to --limit 2048
        battery_run = stage("cnn", "cnn", "--epochs", "1", "--limit", "2048", keep="run_cnn")
        bdef = ResNetDef(mdef.model_name, mdef.image_channels, 2, mdef.iid_classes)
        for label, member in battery_run["value"].items():
            check_loaded(member, load_cnn(battery_run["model"], bdef, label=label,
                                          device=device), f"model_{label}.msgpack (cnn)")

        # 5. AlexNet: cnn-multipatient, then the batched runner on it
        alex = stage("alexnet", "cnn-multipatient", "--epochs", "1",
                     keep="run_cnn_multipatient",
                     **{"model_cnn.model_name": "AlexNet", "model_cnn.network.padding": "same"})
        adef = assessor_factory(load_config(CFG, overrides={
            **data, "model_cnn.model_name": "AlexNet", "model_cnn.network.padding": "same"}),
            data_cfg, len(data_cfg.iid_classes))[0]
        alexnet = load_cnn(alex["model"], adef, device=device)
        check_loaded(alex["value"][0], alexnet, "model.msgpack (AlexNet)")
        hp = PsoConfig(n_iterations=iters, n_particles=int(cfg.trainer_pso.n_particles),
                       dim_space=DIM)
        final, _, seconds, launches = drive_main_path((models[0], alexnet), device, None,
                                                      kernels, hp=hp)
        out["alexnet_runner"] = launches
        if launches != dict.fromkeys(names, iters):
            raise AssertionError(f"AlexNet runner launches {launches}, not {iters} each")
        g = final.g_best_val
        if not (bool(torch.isfinite(g).all()) and bool((g >= EPS).all())
                and bool((g <= 1 + EPS).all())):
            raise AssertionError(f"AlexNet runner: g_best out of [eps, 1+eps]: {g.tolist()}")
        report["alexnet_runner"] = {"seconds": seconds, "g_best": g.tolist()}

        # 6. evaluate_gan_epoch: G(64) z = 100, the phase's CAE and battery
        real01 = val.images
        enc_real = encode(encoder, real01)
        sample = make_sampler(models[0])
        rng = torch.Generator(device=device).manual_seed(SEED + 10)

        def evaluate():
            return evaluate_gan_epoch(sample, encoder, decoder, battery, real01,
                                      n_synthetic=N_SYNTHETIC, enc_real=enc_real, generator=rng)

        zero_counts(kernels)
        res = evaluate()
        torch.cuda.synchronize()
        out["evaluate_gan_epoch"] = {k.__name__: k.launches for k in kernels}
        want = {**none, **({"rescale01_rows": -(-N_SYNTHETIC // 1280)}
                           if "rescale01_rows" in names else {})}
        if out["evaluate_gan_epoch"] != want:
            raise AssertionError(f"evaluate_gan_epoch launches {out['evaluate_gan_epoch']}, "
                                 f"not {want}")
        numbers = evaluation_numbers(res)
        if not (all(np.isfinite(v) for v in numbers.values())
                and tuple(res.p_yx.shape) == (N_SYNTHETIC, len(data_cfg.iid_classes))):
            raise AssertionError(f"evaluate_gan_epoch: {numbers}, p_yx {tuple(res.p_yx.shape)}")
        t0 = time.perf_counter()
        evaluate()
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_steps(evaluate, [()] * 3)
        report["evaluate_gan_epoch"] = {
            **numbers, "n_synthetic": N_SYNTHETIC, "battery_rows": int(battery.train_x.shape[0]),
            "query_chunk": auto_chunk(battery, N_SYNTHETIC), "wall_ms_warm": warm_ms,
            "profiled": prof}

        # 7. 1280 images with injected z and noise, card against CPU, with a
        # torch-default-init G, whose images move with z (a DCGAN-init G's
        # vary by ~1e-5 around its bias, and the per-image rescale would
        # blow the card's and the CPU's rounding up to whole pixels)
        torch.manual_seed(SEED + 11)
        gen_t = Generator(GeneratorDef(DIM, 1, 64)).eval()
        draw = torch.Generator().manual_seed(SEED + 12)
        z = torch.randn((1280, DIM, 1, 1), generator=draw)
        noise = torch.randn((1280, 1, 28, 28), generator=draw)
        pair = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            enc_w, dec_w = (copy.deepcopy(m).to(dev) for m in (encoder, decoder))
            bat = type(battery)(*(t.to(dev) for t in battery[:3]), k=battery.k)
            pair[where] = evaluate_gan_epoch(
                make_sampler(copy.deepcopy(gen_t).to(dev)), enc_w, dec_w, bat, real01.to(dev),
                n_synthetic=1280, z=z.to(dev), noise=noise.to(dev))
        agree = posteriors_agree(pair["card"].p_yx, pair["cpu"].p_yx,
                                 near_tie_rows(encode(encoder, make_sampler(gen_t.to(device))(
                                     1280, z=z.to(device))), battery.train_x, battery.k),
                                 "evaluate_gan_epoch posterior")
        card_n, cpu_n = evaluation_numbers(pair["card"]), evaluation_numbers(pair["cpu"])
        # IS on the rows whose posteriors agree (every row when no near-tie
        # flipped), so that the gate always holds it
        same = ~(pair["card"].p_yx.cpu() != pair["cpu"].p_yx).any(dim=1)
        for nums, res in ((card_n, pair["card"]), (cpu_n, pair["cpu"])):
            nums["is_agreeing_rows"] = float(inception_score(res.p_yx[same.to(res.p_yx.device)]))
        agree["is_rows"] = int(same.sum())
        # the FID is a difference of its trace terms, so its rounding scales
        # with tr(Σ_real) + tr(Σ_syn), not with the FID itself
        cpu_enc = copy.deepcopy(encoder).cpu()
        traces = sum(float(torch.trace(mean_and_cov(encode(cpu_enc, x))[1])) for x in (
            real01.cpu(), make_sampler(copy.deepcopy(gen_t).cpu())(1280, z=z)))
        atol = {"fid": 1e-4 * traces, "rec": 0.0, "is_agreeing_rows": 0.0}
        for key in ("fid", "rec", "is_agreeing_rows"):
            if not np.isclose(card_n[key], cpu_n[key], rtol=1e-4, atol=atol[key]):
                raise AssertionError(f"evaluate_gan_epoch card vs CPU: {key} {card_n[key]} vs "
                                     f"{cpu_n[key]} (rtol 1e-4, atol {atol[key]})")
        report["evaluate_card_vs_cpu"] = {"card": card_n, "cpu": cpu_n, "fid_traces": traces,
                                          **agree}
        if keep_upstream is not None:
            shutil.copytree(cae["model"], keep_upstream / "cae")
            shutil.copytree(cls["model"], keep_upstream / "classifiers")

    for label, launches in out.items():
        if label in ("cae", "classifiers", "cnn_multipatient", "cnn", "alexnet") and \
                launches != none:
            raise AssertionError(f"{label}: launches {launches}; no port kernel is on this "
                                 "stage's path")
    log(f"assessor and evaluation stages ({card}): " + json.dumps(report))
    log(f"assessor and evaluation phase: {time.perf_counter() - t_phase:.6f} s ({card})")
    return out


VQ_CFG = ROOT / "configs" / "vqvae.yaml"
GAN_EPOCHS = 2  # the dcgan stage's run here; configs/dcgan_mnist.yaml trains 100


def gan_step_card_vs_cpu(device, cfg) -> dict:
    """One DCGAN train step at the config's widths (z, f, batch) from
    torch-default-init G and D (a DCGAN-init G's images are flat in z) and
    injected draws, in fp32 parity, on the card and on the CPU, and on the
    CPU in float64 as the reference:
    - both losses, card vs CPU, within rtol 1e-4;
    - the step's gradients (G's of the G loss, D's of the D loss), every
      entry: per tensor, the card's largest difference from float64 at
      most 4 times the CPU's own (fp32 rounding grows through the
      train-mode BNs and through D's Adam step, whose sign flips for
      gradients at rounding level, before G's loss reads D);
    - the updated weights, every entry: w0 − lr·g/(|g| + eps) of the side's
      own gradient g within rtol 1e-4 (atol 1e-7), Adam's first step.
    Returns the losses, each tensor's largest gradient error from float64
    (card, CPU) and the largest weight difference from that update."""
    import copy

    import torch

    from gan_discovery_pso_tpu_torch.core import AdamConfig
    from gan_discovery_pso_tpu_torch.models import (
        Discriminator, DiscriminatorDef, Generator, GeneratorDef, torch_default_init_)
    from gan_discovery_pso_tpu_torch.ops import conv as conv_ops
    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.train.common import make_optimizer
    from gan_discovery_pso_tpu_torch.train.dcgan import GanTrainState, make_gan_train_step

    z_dim, bs = int(cfg.trainer_gan.z_dim), int(cfg.trainer_gan.batch_size)
    rng = torch.Generator().manual_seed(SEED + 20)
    gen = torch_default_init_(Generator(GeneratorDef(z_dim, 1, int(
        cfg.model_gan.network.units_gen))), rng)
    disc = torch_default_init_(Discriminator(DiscriminatorDef(1, int(
        cfg.model_gan.network.units_disc))), rng)
    real = torch.rand((bs, 1, 28, 28), generator=rng) * 2 - 1
    draws = (torch.randn((bs, z_dim, 1, 1), generator=rng),
             0.7 + 0.5 * torch.rand((bs,), generator=rng), 0.3 * torch.rand((bs,), generator=rng))
    adam = AdamConfig.from_config(cfg.trainer_gan.optimizer)
    if adam.weight_decay:
        raise AssertionError(f"GAN step card vs CPU: the check assumes no weight decay, not "
                             f"{adam.weight_decay}")
    w0 = {f"{n}.{k}": v.detach().double() for n, mod in (("G", gen), ("D", disc))
          for k, v in mod.named_parameters()}
    finish = conv_ops._finish
    out = {}
    for where, dev, dtype in (("card", device, torch.float32),
                              ("cpu", torch.device("cpu"), torch.float32),
                              ("float64", torch.device("cpu"), torch.float64)):
        g, d = copy.deepcopy(gen).to(dev, dtype), copy.deepcopy(disc).to(dev, dtype)
        state = GanTrainState(g, d, make_optimizer(adam, list(g.parameters())),
                              make_optimizer(adam, list(d.parameters())))
        if dtype == torch.float64:  # the port's convs return fp32 by design
            conv_ops._finish = lambda o, b: o if b is None else o + b.reshape(1, -1, 1, 1)
        try:
            with fp32_parity():
                m = make_gan_train_step(state)(real.to(dev, dtype),
                                               tuple(t.to(dev, dtype) for t in draws))
        finally:
            conv_ops._finish = finish
        mods = (("G", g), ("D", d))
        out[where] = ({k: float(v) for k, v in m.items()},
                      {f"{n}.{k}": v.detach().double().cpu() for n, mod in mods
                       for k, v in mod.named_parameters()},
                      {f"{n}.{k}": v.grad.detach().double().cpu() for n, mod in mods
                       for k, v in mod.named_parameters()})
    (card_m, card_w, card_g), (cpu_m, cpu_w, cpu_g), (_, _, ref_g) = (
        out["card"], out["cpu"], out["float64"])
    for k in cpu_m:
        if not np.isclose(card_m[k], cpu_m[k], rtol=1e-4, atol=0):
            raise AssertionError(f"GAN step card vs CPU: {k} {card_m[k]} vs {cpu_m[k]}")
    ratios, worst_w = {}, 0.0
    for k, ref in ref_g.items():
        err_card = float((card_g[k] - ref).abs().max())
        err_cpu = float((cpu_g[k] - ref).abs().max())
        if err_card > 4 * err_cpu:
            raise AssertionError(f"GAN step card vs CPU: gradient of {k} off float64 by "
                                 f"{err_card}, > 4 x the CPU's {err_cpu}")
        ratios[k] = [err_card, err_cpu]
        for side, w, grad in (("card", card_w, card_g), ("cpu", cpu_w, cpu_g)):
            want = w0[k] - adam.lr * grad[k] / (grad[k].abs() + adam.epsilon)
            torch.testing.assert_close(w[k], want, rtol=1e-4, atol=1e-7,
                                       msg=f"GAN step: {side} {k} is not Adam's first step")
            worst_w = max(worst_w, float((w[k] - want).abs().max()))
    return {"losses_card": card_m, "losses_cpu": cpu_m, "losses_float64": out["float64"][0],
            "grad_max_err_from_float64_card_cpu": ratios, "max_abs_weight_diff_from_update": worst_w}


def gan_vqvae_phase(models, device, kernels, card: str, upstream: Path, pso_interim: Path,
                    sets=()) -> dict:
    """The DCGAN and the VQ-VAE family through the CLI on the synthetic
    digits, fp32 parity:
    1. `dcgan` at configs/dcgan_mnist.yaml's widths (z 10, G and D f 64,
       batch 128, Adam 1e-3 (0.5, 0.99), label smoothing, 12,800 samples an
       evaluation) for GAN_EPOCHS epochs on the assessor phase's CAE and
       battery (`upstream`): B2 10 launches an epoch (at [1280, 784] in
       the evaluation), B1 0; FID, IS
       and rec finite; each epoch's training, evaluation and artifact
       seconds; best_g read back into G;
    2. `dcgan --epochs GAN_EPOCHS-1`, then `--resume-id 1 --epochs 1` in one
       run dir:
       checkpoint_g.msgpack and history_gan.msgpack byte-equal to step 1's;
    3. 5 steady train steps profiled (wall ms, device idle share), and one
       step on the card against the CPU (`gan_step_card_vs_cpu`);
    4. `vqvae` at configs/vqvae.yaml's widths (embedding 100, K 256, batch
       128) for 1 epoch, the decoder the main path's G (z 100) as a
       JAX-format checkpoint, the codebook the pipeline phase's batched
       particles (`pso_interim`: 8 classes x 32 = 256 rows; the IiD classes
       set to the pipeline's): the codebook at init equal to the particles
       bit for bit, the decoder bit-equal to G after training, a rerun's
       model_1 and best_vqvae byte-equal, near-ties of the codes counted;
    5. `pixelcnn-prior` on that run for 1 epoch.
    None of 4-5 launches a port kernel. Returns each run's launches."""
    import tempfile

    import torch

    from gan_discovery_pso_tpu_torch.core import AdamConfig, load_config
    from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree
    from gan_discovery_pso_tpu_torch.core.config import DataConfig
    from gan_discovery_pso_tpu_torch.data import epoch_batches, load_mnist
    from gan_discovery_pso_tpu_torch.models import DiscriminatorDef, GeneratorDef
    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.pipelines import load_gan, load_vqvae
    from gan_discovery_pso_tpu_torch.pipelines import stages as stage_module
    from gan_discovery_pso_tpu_torch.pso import load_final_particle_positions
    from gan_discovery_pso_tpu_torch.train.dcgan import gan_init, make_gan_train_step

    t_phase = time.perf_counter()
    out, report = {}, {}
    names = [k.__name__ for k in kernels]
    none = dict.fromkeys(names, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_") as tmp_name:
        tmp = Path(tmp_name)
        data = {"data.data_dir": str(tmp / "no_mnist"), **dict(sets)}
        cfg = load_config(CFG, overrides=data)
        data_cfg = DataConfig.from_config(cfg.data)
        bs = int(cfg.trainer_gan.batch_size)
        # the stage's n_synthetic is batch x 100 (12,800), sampled in chunks of 1280
        per_epoch = {**none, **({"rescale01_rows": -(-bs * 100 // 1280)}
                                if "rescale01_rows" in names else {})}
        paths = ("--path-cae", str(upstream / "cae"), "--path-classifiers",
                 str(upstream / "classifiers"))

        def stage(label, name, *args, keep=None, key=None, **extra):
            run = cli_stage(tmp, label, name, device, kernels, *args, sets={**data, **extra},
                            keep=keep)
            tag = f"[{name.replace('-', '_')}]"  # the stage's own lines
            lines = [ln for ln in run["log"].splitlines()
                     if ln.startswith(tag) and "done →" not in ln]
            report[key or label] = {"stage_s": run["wall"], "launches": run["launches"],
                                    "log": lines}
            return run

        def dcgan_files(run) -> list:
            return [(run["model"] / "checkpoint_g.msgpack").read_bytes(),
                    (run["reports"] / "general" / "history_gan.msgpack").read_bytes()]

        # 1. dcgan at the shipped widths
        gan = stage("dcgan", "dcgan", "--epochs", str(GAN_EPOCHS), *paths, keep="run_dcgan")
        out["dcgan"] = gan["launches"]
        expect_launches({**gan, "label": "dcgan"},
                        {k: GAN_EPOCHS * v for k, v in per_epoch.items()})
        _state, history = gan["value"]
        for key in ("fid", "is", "rec_loss_syn", "loss_gen", "loss_disc"):
            if not (len(history[key]) and np.isfinite(history[key]).all()):
                raise AssertionError(f"dcgan: {key} not finite: {history[key]}")
        epochs = [re.findall(r"([0-9.]+)s", ln) for ln in report["dcgan"]["log"]
                  if " train steps " in ln]
        report["dcgan"]["epochs"] = [
            {"train_s": float(a), "evaluation_s": float(b), "artifacts_s": float(c)}
            for a, b, c in epochs]
        report["dcgan"]["history"] = {k: history[k] for k in ("fid", "is", "rec_loss_syn")}
        gen_best = load_gan(gan["model"], device=device)
        check_loaded(_state.gen, gen_best, "best_g.msgpack (dcgan)")

        # 2. GAN_EPOCHS - 1 epochs and 1 resumed against the single run
        first = stage("dcgan_resume", "dcgan", "--epochs", str(GAN_EPOCHS - 1), *paths)
        resumed = stage("dcgan_resume", "dcgan", "--epochs", "1", "--resume-id", "1", *paths,
                        key="dcgan_resumed")
        for label, run, n in (("dcgan_resume", first, GAN_EPOCHS - 1),
                              ("dcgan_resumed", resumed, 1)):
            out[label] = run["launches"]
            expect_launches({**run, "label": label}, {k: n * v for k, v in per_epoch.items()})
        same = [a == b for a, b in zip(dcgan_files(resumed), dcgan_files(gan))]
        if not all(same):
            raise AssertionError(f"dcgan {GAN_EPOCHS - 1} + 1 resumed epochs differ from "
                                 f"{GAN_EPOCHS} epochs in (checkpoint_g, history_gan): {same}")
        report["resume_bit_equal"] = True

        # 3. 5 steady steps profiled; one step on the card against the CPU
        ds = load_mnist(data["data.data_dir"], "train", classes=data_cfg.iid_classes,
                        drange=(-1, 1), device=device)
        st = gan_init(torch.Generator().manual_seed(SEED + 21),
                      GeneratorDef(int(cfg.trainer_gan.z_dim), 1,
                                   int(cfg.model_gan.network.units_gen)),
                      DiscriminatorDef(1, int(cfg.model_gan.network.units_disc)),
                      AdamConfig.from_config(cfg.trainer_gan.optimizer), device=device)
        step = make_gan_train_step(st)
        rng = torch.Generator(device=device).manual_seed(SEED + 22)
        batches = [(x, rng) for x, _y in itertools.islice(
            epoch_batches(ds, bs, torch.Generator().manual_seed(SEED)), 7)]
        report["gan_step_profiled"] = profile_steps(step, batches)
        report["gan_step_card_vs_cpu"] = gan_step_card_vs_cpu(device, cfg)

        # 4. vqvae: G (z 100) as the frozen decoder, the batched particles
        dirs = write_checkpoints(tmp / "upstream", 1, gen=models[0])
        vq_sets = {"data.iid_classes": list(data_cfg.iid_classes), "data.ood_classes": [1, 5]}
        vq_cfg = load_config(VQ_CFG, overrides={**data, **vq_sets})
        classes = DataConfig.from_config(vq_cfg.data).iid_classes
        particles = np.concatenate([load_final_particle_positions(pso_interim, c, "iid")
                                    for c in classes])
        inits = []
        real_init = stage_module.vqvae_init

        def recording(*a, **kw):
            state = real_init(*a, **kw)
            inits.append(state.model.codebook.detach().cpu().numpy().copy())
            return state

        stage_module.vqvae_init = recording
        try:
            vq = [stage(label, "vqvae", "--cfg", str(VQ_CFG), "--epochs", "1", "--path-gan",
                        str(dirs["gan"]), "--path-pso", str(pso_interim), keep="run_vqvae",
                        **vq_sets) for label in ("vqvae", "vqvae_rerun")]
        finally:
            stage_module.vqvae_init = real_init
        if not (len(inits) == 2 and particles.shape == inits[0].shape
                and all(np.array_equal(c, particles) for c in inits)):
            raise AssertionError(f"vqvae: the initial codebook {inits[0].shape} is not the "
                                 f"particles {particles.shape} bit for bit")
        model = load_vqvae(vq[0]["model"], vq_cfg, device=device)
        gen_sd = models[0].state_dict()
        for k, v in model.decoder.state_dict().items():
            if not k.endswith("num_batches_tracked") and not torch.equal(v, gen_sd[k]):
                raise AssertionError(f"vqvae: decoder {k} differs from G after training")
        for name in ("model_1.msgpack", "best_vqvae.msgpack"):
            if (vq[0]["model"] / name).read_bytes() != (vq[1]["model"] / name).read_bytes():
                raise AssertionError(f"vqvae: the rerun's {name} differs")
        val = load_mnist(data["data.data_dir"], "test", classes=classes, drange=(-1, 1),
                         device=device)
        with fp32_parity(), torch.no_grad():
            z_e = model.encoder(val.images, False).flatten(1)
        ties = near_tie_rows(z_e, model.codebook.detach(), 1)
        _vq_state, vq_hist, _d = vq[0]["value"]
        report["vqvae_checks"] = {
            "codebook": list(particles.shape), "codebook_init_equals_particles": True,
            "decoder_equals_G": True, "rerun_bit_equal": True,
            "near_tie_rows_of_test_codes": int(ties.sum()), "rows": int(ties.numel()),
            "history": vq_hist}
        for label in ("vqvae", "vqvae_rerun"):
            out[label] = report[label]["launches"]

        # 5. pixelcnn-prior on the vqvae run
        pix = stage("pixelcnn_prior", "pixelcnn-prior", "--cfg", str(VQ_CFG), "--epochs", "1",
                    "--path-vqvae", str(vq[0]["model"]), **vq_sets)
        out["pixelcnn_prior"] = pix["launches"]
        ck = load_pytree(pix["model"] / "pixelcnn.msgpack")
        rows = (pix["reports"] / "history_pixelcnn.jsonl").read_text().splitlines()
        if int(ck["def"]["input_dim"]) != particles.shape[0] or not np.isfinite(
                json.loads(rows[0])["train_loss"]):
            raise AssertionError(f"pixelcnn-prior: def {ck['def']}, history {rows}")
        report["pixelcnn_prior"]["def"] = {k: int(v) for k, v in ck["def"].items()}

    for label in ("vqvae", "vqvae_rerun", "pixelcnn_prior"):
        if out[label] != none:
            raise AssertionError(f"{label}: launches {out[label]}; no port kernel is on this "
                                 "stage's path")
    log(f"dcgan and vq-vae stages ({card}): " + json.dumps(report))
    log(f"dcgan and vq-vae phase: {time.perf_counter() - t_phase:.6f} s ({card})")
    return out


CLARO_CFG = ROOT / "configs" / "claro_preprocess.yaml"
CLARO_PATIENTS, CLARO_SLICES, CT_SIZE = 2, 64, 512  # 2 patients x 64 slices of 512 x 512 HU
UMAP_CHECK_EPOCHS = 10  # layout epochs held card vs CPU, each from the same state
UMAP_TIMED_FITS = 5  # default fits of the final positions timed one by one
# the graph's float values card vs CPU: its distances come from the expanded
# form, whose float64 rounding (~eps·‖x‖²/d) differs between cuBLAS and the
# CPU's BLAS; rho reached 1e-9 relative on the pipeline's particles
UMAP_GRAPH_TOL = 1e-7
UMAP_EPOCH_RTOL = 1e-4  # of the embedding's largest |value|, one epoch
PCA_RTOL = 1e-9
# a pair's squared distance, card vs CPU: float32 particles by the expanded
# form ‖a‖² + ‖b‖² − 2a·b, as the JAX package computes it, whose rounding
# differs between cuBLAS and the CPU's BLAS by up to ~√d·eps·(‖a‖² + ‖b‖²);
# the bound is 8 times that
DISTANCE_SQ_BOUND = 8.0
RESIZE_TOL = 2e-6  # of the input's range (ops/resize.py)
CLARO_TOL = 5e-6  # a preprocessed slice in [0, 1]: the resize's error over the 2000 HU scale
AUGMENT_TOL = 1e-4  # an augmented image in [0, 1]


def write_claro_input(root: Path, seed: int = SEED) -> list:
    """CLARO_PATIENTS x CLARO_SLICES int16 CT slices of CT_SIZE² in HU (air
    -1000, a body ellipse of soft tissue, two lungs around -800, noise),
    written by the port's TIFF writer under raw/<dataset>/<patient>/images,
    the patients_info manifest under interim/<dataset>/, and a box manifest
    of lung-sized boxes (some leave the frame once squared). Returns the
    slice ids."""
    from gan_discovery_pso_tpu_torch.data.tiff import write_tiff
    from gan_discovery_pso_tpu_torch.data.xlsx import write_xlsx

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:CT_SIZE, :CT_SIZE] / CT_SIZE - 0.5
    body = (yy / 0.38) ** 2 + (xx / 0.46) ** 2 < 1
    lungs = ((yy / 0.27) ** 2 + ((xx - 0.18) / 0.14) ** 2 < 1) | (
        (yy / 0.27) ** 2 + ((xx + 0.18) / 0.14) ** 2 < 1)
    dataset = "claro_prospettivo"
    ids, boxes = [], []
    for p in range(CLARO_PATIENTS):
        d = root / "raw" / dataset / f"PAT{p + 1}" / "images"
        d.mkdir(parents=True)
        for s in range(CLARO_SLICES):
            hu = np.where(body, 40.0, -1000.0) + np.where(lungs, -840.0, 0.0)
            hu += rng.normal(0, 30, hu.shape) + 300 * np.sin(3 * xx + s / 9.0) * body
            sid = f"PAT{p + 1}_{s}"
            write_tiff(d / f"{sid}.tif", np.clip(hu, -1024, 3071).astype(np.int16))
            y0, x0 = rng.randint(110, 150), rng.randint(60, 100)
            boxes.append(f"[{y0}, {x0}, {y0 + rng.randint(250, 300)}, "
                         f"{x0 + rng.randint(330, 390)}]")
            ids.append(sid)
    info = root / "interim" / dataset
    info.mkdir(parents=True)
    write_xlsx(info / f"patients_info_{dataset}.xlsx",
               {"image": [f"{i.split('_')[0]}/images/{i}.tif" for i in ids]})
    write_xlsx(root / "boxes.xlsx", {"img ID": ids, "max_box": boxes})
    return ids


def umap_card_vs_cpu(x: np.ndarray, device) -> dict:
    """UMAP on the card against the CPU on the same [N, d] points:
    - the graph's rows: the k nearest equal, rho and sigma within
      UMAP_GRAPH_TOL relative and the memberships (in [0, 1]) within
      UMAP_GRAPH_TOL, on every row but those whose first k+1
      distances hold a near-tie (k-th and (k+1)-th within UMAP_GRAPH_TOL) or a
      distance at the expanded form's rounding level (d² ≤ 64·eps·2·max‖x‖²:
      duplicate particles of a converged swarm), which are counted; where
      no row is excluded, the edges (heads, tails) equal and their weights
      within UMAP_GRAPH_TOL;
    - UMAP_CHECK_EPOCHS layout epochs on the CPU's graph, each run on both
      from the card's state with the same draws, within UMAP_EPOCH_RTOL of
      the scale; the divergence of 10 epochs run apart (reported: the
      layout is chaotic at rounding level);
    - a full default fit twice on the card, bit-equal;
    - UMAP_TIMED_FITS default fits timed one by one, and one fit and its
      layout alone profiled (`profile_umap`)."""
    import torch

    from gan_discovery_pso_tpu_torch.analysis.cluster import PCA
    from gan_discovery_pso_tpu_torch.analysis.umap_impl import (
        UMAP, LayoutDraws, _knn, _memberships, _smooth_knn, find_ab_params, layout_draws,
        optimize_layout)

    k = UMAP(device=device).n_neighbors
    rows, graphs = {}, {}
    for dev in (device, torch.device("cpu")):
        xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
        idx, d = _knn(xt, k + 1)
        rho, sigma = _smooth_knn(d[:, :k], k)
        rows[dev.type] = [v.cpu() for v in (idx[:, :k], d, rho, sigma,
                                            _memberships(d[:, :k], rho, sigma))]
        graphs[dev.type] = [v.cpu() for v in UMAP(device=dev).build_graph(xt)[1]]
    (i_a, _, *vals_a), (i_b, d_b, *vals_b) = rows[device.type], rows["cpu"]
    floor = 64 * np.finfo(np.float64).eps * 2 * float((x.astype(np.float64) ** 2).sum(1).max())
    excluded = ((d_b ** 2 <= floor).any(dim=1)
                | ((d_b[:, k] - d_b[:, k - 1]).abs() <= UMAP_GRAPH_TOL * d_b[:, k]))
    clean = ~excluded
    worst = {}
    if not torch.equal(i_a[clean], i_b[clean]):
        raise AssertionError("umap graph: the k nearest differ between the card and the CPU "
                             f"on {int((i_a != i_b).any(1)[clean].sum())} clean rows")
    for name, a, b in zip(("rho", "sigma", "memberships"), vals_a, vals_b):
        a, b = a[clean], b[clean]
        scale = b.abs() if name != "memberships" else torch.ones_like(b)  # those in [0, 1]
        worst[name] = float(((a - b).abs() / scale.clamp_min(1e-300)).max()) if len(b) else 0.0
        if worst[name] > UMAP_GRAPH_TOL:
            raise AssertionError(f"umap graph: {name} card vs CPU {worst[name]:.3e} > "
                                 f"{UMAP_GRAPH_TOL}")
    (h_a, t_a, w_a), (h, t, w) = graphs[device.type], graphs["cpu"]
    if not bool(excluded.any()):
        if not (torch.equal(h_a, h) and torch.equal(t_a, t)):
            raise AssertionError("umap graph: the edges differ between the card and the CPU")
        worst["weights"] = float((w_a - w).abs().max())  # in [0, 1]
        if worst["weights"] > UMAP_GRAPH_TOL:
            raise AssertionError(f"umap graph: weights card vs CPU {worst['weights']:.3e}")
    init = PCA(2, device="cpu").fit_transform(x)
    init = init / np.abs(init).max() * 10.0
    init = init + np.random.RandomState(42).normal(0, 1e-4, init.shape)
    a, b = find_ab_params(1.0, 0.1)
    probs = (w / w.max()).to(torch.float32)
    draws = layout_draws(200, len(h), 5, len(x), 42, device="cpu")
    on = lambda dev: dict(heads=h.to(dev), tails=t.to(dev), probs=probs.to(dev),  # noqa: E731
                          draws=LayoutDraws(*(d.to(dev) for d in draws)))
    args_card, args_cpu = on(device), on("cpu")
    y = torch.as_tensor(init, dtype=torch.float32)
    worst_epoch = 0.0
    for ep in range(UMAP_CHECK_EPOCHS):
        nxt = optimize_layout(y.to(device), None, a=a, b=b, lr=1.0, epochs=[ep],
                              **args_card).cpu()
        ref = optimize_layout(y, None, a=a, b=b, lr=1.0, epochs=[ep], **args_cpu)
        err = float((nxt - ref).abs().max() / ref.abs().max())
        worst_epoch = max(worst_epoch, err)
        if err > UMAP_EPOCH_RTOL:
            raise AssertionError(f"umap epoch {ep}: card vs CPU {err:.3e} of the scale > "
                                 f"{UMAP_EPOCH_RTOL}")
        y = nxt
    apart = [optimize_layout(torch.as_tensor(init, dtype=torch.float32).to(dev), None, a=a,
                             b=b, lr=1.0, epochs=range(UMAP_CHECK_EPOCHS), **args).cpu()
             for dev, args in ((device, args_card), ("cpu", args_cpu))]
    fits = [UMAP(device=device).fit_transform(x) for _ in range(2)]
    if not np.array_equal(*fits):
        raise AssertionError("umap: two fits on the card differ")
    fit_s = []
    for _ in range(UMAP_TIMED_FITS):
        t0 = time.perf_counter()
        UMAP(device=device).fit_transform(x)
        fit_s.append(time.perf_counter() - t0)
    y0 = torch.as_tensor(init, dtype=torch.float32, device=device)
    profiled = profile_umap(
        lambda: UMAP(device=device).fit_transform(x),
        lambda: optimize_layout(y0, None, a=a, b=b, lr=1.0, **args_card),
        n_epochs=len(draws.uniform))
    return {"graph_edges": int(len(h)), "graph_rows_excluded": int(excluded.sum()),
            "graph_card_vs_cpu_rel": worst, "epoch_worst_rel": worst_epoch,
            "epochs_apart_max_abs": float((apart[0] - apart[1]).abs().max()),
            "scale": float(apart[1].abs().max()), "rerun_bit_equal": True,
            "fit_s": fit_s, "profile": profiled}


def profile_umap(fit, layout, n_epochs: int) -> dict:
    """Where a default UMAP fit's time goes on the card: `fit` (the whole
    fit) and `layout` (its `n_epochs` layout epochs alone), each once warm
    and once under torch.profiler: wall, device busy time and idle share
    (`device_summary`), the device events (kernels, copies, sets) per
    epoch, and the host's calls that copy or wait, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in (("fit", fit), ("layout", layout)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        device_events, host_waits = 0, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                device_events += not getattr(e, "is_user_annotation", False)
            elif e.name.startswith("cuda") and ("Sync" in e.name or "Memcpy" in e.name):
                host_waits[e.name] = host_waits.get(e.name, 0) + 1
        out[name] = {**device_summary(prof, seconds),
                     "device_events_per_epoch": device_events / n_epochs,
                     "host_copy_or_sync_calls": host_waits}
    return out


def analysis_claro_phase(device, kernels, card: str, pso_interim: Path, dim2_interim: Path,
                         ood_interim: Path, sets=()) -> dict:
    """The latent analyses and the CLARO data layer through the CLI, on the
    card, at the shipped sizes:
    1. `pso-analysis` on the pipeline phase's batched particles (8 classes
       x 32 particles x 51 recorded iterations, z = 100): 51 PCA + UMAP fits
       of 256 x 100 and the final one; the stage's PCA and UMAP seconds;
       the final positions' PCA card vs CPU (PCA_RTOL, allowing for sign)
       and UMAP (`umap_card_vs_cpu`);
    2. `pso-analysis-clustering` with kmeans and with em on the same
       particles, the inverter phase's 256 OoD latents overlaid (patient
       PATIENT), and on the dimension-2 run with each: the fitted
       {algorithm}.pkl's labels equal to a CPU fit's, its assignment of the
       OoD latents equal to the CPU model's;
    3. `pso-analysis-distance`, and every pair's distance of it on the
       card against the CPU within DISTANCE_SQ_BOUND (in squared distance:
       the expanded form's float32 rounding); the summary's difference
       from a CPU run reported (a converged class's distances are at that
       rounding, so its mean and std carry no digits to hold);
    4. `pso-inverter-analysis` of the 256 OoD latents: the assignment equal
       to the CPU clustering's;
    5. `claro-preprocess` at configs/claro_preprocess.yaml's image_size 256
       on `write_claro_input`'s 128 slices, and a rerun byte-equal; the
       resize of the 128 cropped slices card vs CPU (RESIZE_TOL of the
       range), 8 slices of the stack card vs CPU (CLARO_TOL);
    6. `augment_batch` on the 128 x 1 x 256 x 256 stack with zoom and
       elastic on, draws from `draw_augment`: its time, card vs CPU
       (AUGMENT_TOL).
    No port kernel is on these paths: B1 and B2 launch 0 times in each.
    Returns each run's launches."""
    import importlib.util
    import tempfile

    import torch

    from gan_discovery_pso_tpu_torch.analysis.latent import (
        cluster_latents, mutual_distance, pca_project)
    from gan_discovery_pso_tpu_torch.data.augment import (
        AugmentConfig, augment_batch, draw_augment)
    from gan_discovery_pso_tpu_torch.data.medical import (
        ClipSpec, crop_box, load_tiff, prepare_patient_dataset, read_box_manifest)
    from gan_discovery_pso_tpu_torch.ops.resize import resize_bilinear
    from gan_discovery_pso_tpu_torch.pso import load_final_particle_positions

    t_phase = time.perf_counter()
    host = {p: importlib.util.find_spec(p) is not None for p in ("sklearn", "PIL", "matplotlib")}
    log(f"analysis and claro: importable on this host: {json.dumps(host)}")
    names = [k.__name__ for k in kernels]
    none = dict.fromkeys(names, 0)
    out, report = {}, {}
    cpu = torch.device("cpu")
    iid = (0, 2, 3, 4, 6, 7, 8, 9)  # the pipeline phase's classes (configs/dcgan_mnist.yaml)
    overlay = {"data.ood_classes": f"[{PATIENT}]", **dict(sets)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ana_") as tmp_name:
        tmp = Path(tmp_name)

        def stage(label, name, *args, dev=device, **kw):
            run = cli_stage(tmp, label, name, dev, kernels, *args, **kw)
            tag = f"[{name.replace('-', '_')}]"
            report[label] = {"stage_s": run["wall"], "launches": run["launches"],
                             "log": [ln for ln in run["log"].splitlines()
                                     if ln.startswith(tag) and "done →" not in ln]}
            out[label] = run["launches"]
            return run

        # 1. pso-analysis: 51 PCA + UMAP fits of 256 x 100
        run = stage("pso_analysis", "pso-analysis", "--path-pso", str(pso_interim),
                    sets=dict(sets))
        line = next(ln for ln in report["pso_analysis"]["log"] if "iterations of" in ln)
        fit_s = {k: log_seconds(line, rf"{k} ([0-9.]+) s") for k in ("pca", "umap", "plots")}
        report["pso_analysis"].update(fit_s, umap_share=fit_s["umap"] / run["wall"])
        with open(run["reports"] / "general" / "overall_history.pkl", "rb") as f:
            hist = pickle.load(f)
        final = np.concatenate([load_final_particle_positions(pso_interim, c) for c in iid])
        if hist["pca"].shape != (len(final), 2) or not np.isfinite(hist["umap"]).all():
            raise AssertionError(f"pso-analysis: pca {hist['pca'].shape}, umap finite "
                                 f"{np.isfinite(hist['umap']).all()}")
        (p_card, m_card), (p_cpu, m_cpu) = (
            pca_project(final, min(final.shape), return_model=True, device=d)
            for d in (device, cpu))
        var_err = float(np.abs(m_card.explained_variance_ - m_cpu.explained_variance_).max()
                        / m_cpu.explained_variance_.max())
        # the plotted components; a converged swarm leaves trailing ones degenerate
        sign = np.sign((p_card[:, :2] * p_cpu[:, :2]).sum(axis=0))
        pca_err = float(np.abs(p_card[:, :2] * sign - p_cpu[:, :2]).max()
                        / np.abs(p_cpu[:, :2]).max())
        if max(pca_err, var_err) > PCA_RTOL:
            raise AssertionError(f"pso-analysis: PCA card vs CPU {pca_err:.3e}, variances "
                                 f"{var_err:.3e} > {PCA_RTOL} (signs {sign})")
        report["pso_analysis"]["pca_signs_card_vs_cpu"] = sign.tolist()
        report["pso_analysis"]["pca_variance_card_vs_cpu_rel"] = var_err
        report["pso_analysis"]["pca_card_vs_cpu_rel"] = pca_err
        report["pso_analysis"]["umap_card_vs_cpu"] = umap_card_vs_cpu(final, device)

        # 2. pso-analysis-clustering: kmeans and em, 100-d with the OoD overlay, and dim 2
        ood = load_final_particle_positions(ood_interim, PATIENT, "ood").astype(np.float64)
        for algo in ("kmeans", "em"):
            for dim, src in ((DIM, pso_interim), (2, dim2_interim)):
                label = f"clustering_{algo}_{dim}"
                flags = ("--path-ood-pso", str(ood_interim)) if dim == DIM else ()
                run = stage(label, "pso-analysis-clustering", "--path-pso", str(src), *flags,
                            sets={**overlay, "trainer_pso_analysis.clustering_algorithm": algo})
                data = np.concatenate([load_final_particle_positions(src, c) for c in iid])
                with open(run["model"] / f"{algo}.pkl", "rb") as f:
                    model = pickle.load(f)
                labels, _, cpu_model = cluster_latents(data, algo, len(iid), seed=42, device=cpu)
                if not np.array_equal(model.predict(data), labels):
                    raise AssertionError(f"{label}: labels on the card differ from the CPU's")
                if dim == DIM:
                    got = json.loads((run["reports"] / "ood_cluster_assignment.json").read_text())
                    want = cpu_model.predict(ood).tolist()
                    if got[str(PATIENT)]["assignment"] != want:
                        raise AssertionError(f"{label}: OoD assignment differs from the CPU's")
                report[label]["clusters"] = int(len(np.unique(labels)))

        # 3. pso-analysis-distance, card and CPU
        run = stage("distance", "pso-analysis-distance", "--path-pso", str(pso_interim),
                    sets=dict(sets))
        ref = cli_stage(tmp, "distance_cpu", "pso-analysis-distance", cpu, kernels,
                        "--path-pso", str(pso_interim), sets=dict(sets))
        got, want = (json.loads((r["reports"] / "distance_summary.json").read_text())
                     for r in (run, ref))
        if got.keys() != want.keys():
            raise AssertionError(f"distance: keys {sorted(got)} vs {sorted(want)}")
        mats = {c: load_final_particle_positions(pso_interim, c)[:250] for c in iid}
        worst = 0.0
        for i, a in enumerate(iid):
            for b in iid[i:]:
                sq = [mutual_distance(mats[a], mats[b], device=d).astype(np.float64) ** 2
                      for d in (device, cpu)]
                norms = ((mats[a].astype(np.float64) ** 2).sum(1)[:, None]
                         + (mats[b].astype(np.float64) ** 2).sum(1)[None, :]).ravel()
                bound = np.sqrt(DIM) * np.finfo(np.float32).eps * norms
                worst = max(worst, float((np.abs(sq[0] - sq[1]) / bound).max()))
        if worst > DISTANCE_SQ_BOUND:
            raise AssertionError(f"distance: a pair's squared distance card vs CPU is "
                                 f"{worst:.3f} x sqrt(d)·eps·(|a|²+|b|²) > "
                                 f"{DISTANCE_SQ_BOUND}")
        report["distance"].update(
            pair_sq_error_over_rounding=worst,
            summary_card_vs_cpu_rel=max(abs(got[k][s] - want[k][s]) / abs(want[k][s])
                                        for k in want for s in ("mean", "std")))

        # 4. pso-inverter-analysis on the 256 OoD latents
        run = stage("inverter_analysis", "pso-inverter-analysis", "--path-pso", str(pso_interim),
                    "--path-ood-pso", str(ood_interim), "--ood-patient", str(PATIENT),
                    sets=dict(sets))
        rep = json.loads((run["reports"] / f"ood_patient_{PATIENT}_cluster_assignment.json")
                         .read_text())
        data = np.concatenate([load_final_particle_positions(pso_interim, c) for c in iid])
        _, _, cpu_model = cluster_latents(data, rep["algorithm"], len(iid), seed=42, device=cpu)
        if rep["n_ood_latents"] != len(ood) or rep["cluster_assignment"] != \
                cpu_model.predict(ood).tolist():
            raise AssertionError("inverter analysis: the assignment differs from the CPU's")
        report["inverter_analysis"]["cluster_counts"] = rep["cluster_counts"]

        # 5. claro-preprocess at 256 on 2 x 64 slices of 512 x 512, and a rerun
        t0 = time.perf_counter()
        root = tmp / "claro_input"
        ids = write_claro_input(root)
        write_s = time.perf_counter() - t0
        claro = {"data.data_dir": str(root / "raw"), "data.box_file": str(root / "boxes.xlsx"),
                 **dict(sets)}
        runs = []
        for label in ("claro", "claro_rerun"):
            shutil.copytree(root / "interim" / "claro_prospettivo",
                            tmp / label / "interim" / "claro_prospettivo")
            runs.append(stage(label, "claro-preprocess", cfg=CLARO_CFG,
                              dataset="claro_prospettivo", sets=claro))
        stack = np.load(runs[0]["interim"] / "claro_preprocessed.npz")["images"]
        again = np.load(runs[1]["interim"] / "claro_preprocessed.npz")["images"]
        tifs = sorted((runs[0]["interim"] / "stylegan").glob("*.tif"))
        if stack.shape != (len(ids), 1, 256, 256) or len(tifs) != len(ids) or not (
                np.isfinite(stack).all() and stack.min() >= 0 and stack.max() <= 1):
            raise AssertionError(f"claro: stack {stack.shape} in [{stack.min()}, "
                                 f"{stack.max()}], {len(tifs)} TIFFs")
        if not np.array_equal(stack, again) or any(
                p.read_bytes() != (runs[1]["interim"] / "stylegan" / p.name).read_bytes()
                for p in tifs):
            raise AssertionError("claro: the rerun's stack or TIFFs differ")
        boxes = read_box_manifest(root / "boxes.xlsx", "max_box")
        crops = [crop_box(load_tiff(root / "raw" / "claro_prospettivo" / i.split("_")[0] /
                                    "images" / f"{i}.tif"), boxes[i], 0.5) for i in sorted(ids)]
        worst = 0.0
        for c in crops:
            x = torch.as_tensor(np.asarray(c, np.float32))
            diff = (resize_bilinear(x.to(device), 256).cpu() - resize_bilinear(x, 256)).abs()
            worst = max(worst, float(diff.max() / (x.max() - x.min())))
        if worst > RESIZE_TOL:
            raise AssertionError(f"resize: card vs CPU {worst:.3e} of the range > {RESIZE_TOL}")
        sub = sorted(ids)[::len(ids) // 8]
        clip = ClipSpec(-1000.0, 1000.0)
        cpu_stack, _ = prepare_patient_dataset(root / "raw", "claro_prospettivo", sub, 256,
                                               boxes=boxes, clip=clip, scale=clip, device=cpu)
        pos = [sorted(ids).index(i) for i in sub]
        claro_err = float(np.abs(stack[pos] - cpu_stack).max())
        if claro_err > CLARO_TOL:
            raise AssertionError(f"claro: card vs CPU {claro_err:.3e} > {CLARO_TOL}")
        report["claro"].update(input_write_s=write_s, resize_card_vs_cpu_rel=worst,
                               stack_card_vs_cpu=claro_err, slices=len(ids))

        # 6. augment_batch on the stack, zoom and elastic on
        cfg = AugmentConfig(zoom=True, elastic=True)
        imgs = torch.as_tensor(stack)
        draws = draw_augment(len(stack), 256, 256, cfg, torch.Generator().manual_seed(SEED),
                             device=cpu)
        dev_imgs = imgs.to(device)
        dev_draws = type(draws)(*(d.to(device) for d in draws))
        augment_batch(dev_imgs, cfg, dev_draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug = augment_batch(dev_imgs, cfg, dev_draws)
        torch.cuda.synchronize()
        aug_s = time.perf_counter() - t0
        aug_err = float((aug.cpu() - augment_batch(imgs, cfg, draws)).abs().max())
        if aug_err > AUGMENT_TOL:
            raise AssertionError(f"augment: card vs CPU {aug_err:.3e} > {AUGMENT_TOL}")
        report["augment"] = {"shape": list(aug.shape), "warm_s": aug_s,
                             "card_vs_cpu": aug_err}

    for label, launches in out.items():
        if launches != none:
            raise AssertionError(f"{label}: launches {launches}; no port kernel is on this "
                                 "stage's path")
    log(f"analysis and claro stages ({card}): " + json.dumps(report))
    log(f"analysis and claro phase: {time.perf_counter() - t_phase:.6f} s ({card})")
    return out


def split_work(kernel: str, b, n, d) -> tuple[int, int]:
    """(bytes, fp32 operations) of one split half on a shard [b, n, d]:
    each input read once, each output written once. swarm_pbest_local reads
    one of pos and p_best_pos per row (pos where the row improved), p_best_val
    and the fitness, and writes p_best_pos, p_best_val, the candidate row and
    value, and its index; swarm_move reads pos, vel, p_best_pos, r1, r2, the
    winner, one g-best row and the [B] scalars, and writes pos, vel, the
    g-best row, two [B] values and a flag."""
    if kernel == "swarm_pbest_local":
        nbytes = 4 * b * (n * d + 2 * n) + 4 * b * (n * d + n + d + 2)
        return nbytes, 2 * b * n
    nbytes = 4 * b * (3 * n * d + 2 * n + 2 * d + 4) + 4 * b * (2 * n * d + d + 2) + b
    return nbytes, 10 * b * n * d + 2 * b * n


def check_split(models, device) -> tuple[list, dict]:
    """B1's split halves against their plain versions over chained
    iterations at every shape of SPLIT_SHAPES, each swarm cut into SHARDS
    shards of rows: real fitness values where d is the generator's, forced
    exact ties, a NaN fitness, and an all-inf start. Per iteration each
    shard's `swarm_pbest_local` is bit-equal to its plain version; the
    winner is picked from the shards' candidates by `order_key`, as the
    collective picks it; each shard's `swarm_move` is bit-equal to its
    plain version; and the shards together are bit-equal to
    `swarm_update_plain` on the whole swarm. Returns the two kernels'
    records (without times and launches) and what `time_kernel` times at
    SPLIT_TIMED, per kernel, from the first shard."""
    import torch

    from gan_discovery_pso_tpu_torch.ops.kernels import (
        swarm_move, swarm_move_plain, swarm_pbest_local, swarm_pbest_local_plain,
        swarm_update_plain)
    from gan_discovery_pso_tpu_torch.parallel.swarm_sharding import order_key
    from gan_discovery_pso_tpu_torch.pso import state_from_positions

    rng = torch.Generator(device=device).manual_seed(SEED + 30)
    err = 0.0
    timed = {"swarm_pbest_local": {}, "swarm_move": {}}
    for b, n, d in SPLIT_SHAPES:
        pos = torch.randn((b, SHARDS * n if (b, n, d) in SPLIT_TIMED else n, d),
                          generator=rng, device=device)
        n_all = pos.shape[1]
        vel = (torch.randn(pos.shape, generator=rng, device=device) - 0.5) / 10.0
        s = state_from_positions(pos, vel, 0.73)
        classes = torch.arange(b, device=device) % N_CLASSES
        cuts = [0, n_all // 2, n_all]
        for it in range(5):
            if it == 0:
                fit = torch.full((b, n_all), torch.inf, device=device)
            elif d == DIM:
                fit = real_fitness(models, s.positions, classes)
            else:
                fit = (s.positions * s.positions).sum(dim=2)
            if it >= 2:  # exact ties at the minimum: the first index must win
                fit[:, 1::3] = fit.amin(dim=1, keepdim=True)
            if it == 3:  # a NaN comes first
                fit[:, n_all - 1] = torch.nan
            r1 = torch.rand((b, n_all), generator=rng, device=device)
            r2 = torch.rand((b, n_all), generator=rng, device=device)
            w = torch.full((b,), 0.73 * 0.99 ** it, device=device)
            whole = swarm_update_plain(s.positions, s.velocities, s.p_best_pos, s.p_best_val,
                                       fit, r1, r2, s.g_best_pos, s.g_best_val, s.g_prev_val, w,
                                       1.496, 1.496)
            rows = [slice(lo, hi) for lo, hi in zip(cuts, cuts[1:])]
            part = lambda t, r: t[:, r].contiguous()  # noqa: E731
            local = []
            for r in rows:
                args = (part(s.positions, r), part(s.p_best_pos, r), part(s.p_best_val, r),
                        part(fit, r), r.start)
                got, want = swarm_pbest_local(*args), swarm_pbest_local_plain(*args)
                torch.cuda.synchronize()
                for x, y in zip(got, want):
                    err = max(err, bits_equal(x, y))
                local.append(got)
                if r.start == 0:
                    timed["swarm_pbest_local"][(b, n, d)] = args
            keys = torch.stack([order_key(c.candidate[:, -1], c.cand_index) for c in local])
            pick = keys.argmin(dim=0)
            winner = torch.stack([local[int(k)].candidate[i] for i, k in enumerate(pick)])
            moved = []
            for r, loc in zip(rows, local):
                args = (part(s.positions, r), part(s.velocities, r), loc.p_best_pos,
                        part(r1, r), part(r2, r), winner, s.g_best_pos, s.g_best_val,
                        s.g_prev_val, w, 1.496, 1.496)
                got, want = swarm_move(*args), swarm_move_plain(*args)
                torch.cuda.synchronize()
                for x, y in zip(got, want):
                    err = max(err, bits_equal(x, y))
                moved.append(got)
                if r.start == 0:
                    timed["swarm_move"][(b, n, d)] = args
            cat = lambda xs: torch.cat(xs, dim=1)  # noqa: E731
            for x, y in ((cat([m.positions for m in moved]), whole.positions),
                         (cat([m.velocities for m in moved]), whole.velocities),
                         (cat([c.p_best_pos for c in local]), whole.p_best_pos),
                         (cat([c.p_best_val for c in local]), whole.p_best_val),
                         (moved[0].g_best_pos, whole.g_best_pos),
                         (moved[0].g_best_val, whole.g_best_val),
                         (moved[0].g_prev_val, whole.g_prev_val),
                         (moved[0].g_appended, whole.g_appended)):
                err = max(err, bits_equal(x, y))
            s = s._replace(positions=whole.positions, velocities=whole.velocities,
                           p_best_pos=whole.p_best_pos, p_best_val=whole.p_best_val,
                           g_best_pos=whole.g_best_pos, g_best_val=whole.g_best_val,
                           g_prev_val=whole.g_prev_val)
        log(f"swarm_pbest_local + swarm_move [{b},{n_all},{d}] in {SHARDS} shards: each "
            "bit-equal to plain, together bit-equal to swarm_update_plain, over 5 iterations")
    records, to_time = [], {}
    for name in ("swarm_pbest_local", "swarm_move"):
        records.append({"name": name, "route": "cuda",
                        "source": "gan_discovery_pso_tpu_torch/csrc/swarm_update.cu",
                        "replaces": "gan_discovery_pso_tpu/ops/pallas/swarm_update.py:32",
                        "max_abs_err": err, "library_ms": None, "parity": "bitwise",
                        "shape": list(SPLIT_TIMED[0])})
        to_time[name] = []
        for shape in SPLIT_TIMED:
            to_time[name].append((shape, timed[name][shape], split_work(name, *shape),
                                  shape == (1, 2048, 1024)))
    return records, to_time


def dp_step_case(cfg) -> dict:
    """The data-parallel GAN step's case at the config's widths (z, f,
    batch): torch-default-init G and D, a real batch and the step's draws,
    all on the CPU, made alike in every process from one seed."""
    import torch

    from gan_discovery_pso_tpu_torch.core import AdamConfig
    from gan_discovery_pso_tpu_torch.models import (
        Discriminator, DiscriminatorDef, Generator, GeneratorDef, torch_default_init_)

    z_dim, bs = int(cfg.trainer_gan.z_dim), int(cfg.trainer_gan.batch_size)
    rng = torch.Generator().manual_seed(SEED + 40)
    gen = torch_default_init_(Generator(GeneratorDef(z_dim, 1, int(
        cfg.model_gan.network.units_gen))), rng)
    disc = torch_default_init_(Discriminator(DiscriminatorDef(1, int(
        cfg.model_gan.network.units_disc))), rng)
    real = torch.rand((bs, 1, 28, 28), generator=rng) * 2 - 1
    draws = (torch.randn((bs, z_dim, 1, 1), generator=rng),
             0.7 + 0.5 * torch.rand((bs,), generator=rng), 0.3 * torch.rand((bs,), generator=rng))
    return {"gen": gen, "disc": disc, "real": real, "draws": draws,
            "adam": AdamConfig.from_config(cfg.trainer_gan.optimizer)}


DP_WARM_STEPS = 5  # steps timed after the checked one


def dp_step(case: dict, device, dtype, group=None, warm: int = 0) -> dict:
    """One GAN step of `case` on `device` in `dtype` (fp32 parity), over the
    process group `group` where given: its losses, and G's and D's weights,
    gradients and BN statistics afterwards, as float64 on the CPU; then
    `warm` more steps on the same batch, their mean wall ms."""
    import copy

    import torch

    from gan_discovery_pso_tpu_torch.ops import conv as conv_ops
    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.train.common import make_optimizer
    from gan_discovery_pso_tpu_torch.train.dcgan import GanTrainState, make_gan_train_step

    g = copy.deepcopy(case["gen"]).to(device, dtype)
    d = copy.deepcopy(case["disc"]).to(device, dtype)
    state = GanTrainState(g, d, make_optimizer(case["adam"], list(g.parameters())),
                          make_optimizer(case["adam"], list(d.parameters())))
    finish = conv_ops._finish
    if dtype == torch.float64:  # the port's convs return fp32 by design
        conv_ops._finish = lambda o, b: o if b is None else o + b.reshape(1, -1, 1, 1)
    try:
        with fp32_parity():
            step = make_gan_train_step(state, group=group)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            real = case["real"].to(device, dtype)
            draws = tuple(t.to(device, dtype) for t in case["draws"])
            m = step(real, draws)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            mods = (("G", g), ("D", d))
            host = lambda t: t.detach().double().cpu()  # noqa: E731
            out = {"losses": {k: float(v) for k, v in m.items()}, "seconds": seconds,
                   "weights": {f"{n}.{k}": host(v) for n, mod in mods
                               for k, v in mod.named_parameters()},
                   "grads": {f"{n}.{k}": host(v.grad) for n, mod in mods
                             for k, v in mod.named_parameters()},
                   "bn": {f"G.{k}": host(v) for k, v in g.named_buffers() if "running" in k}}
            if warm:
                t0 = time.perf_counter()
                for _ in range(warm):
                    step(real, draws)
                torch.cuda.synchronize()
                out["steady_ms"] = (time.perf_counter() - t0) / warm * 1e3
    finally:
        conv_ops._finish = finish
    return out


def check_dp_step(dp: dict, one: dict, cpu: dict, ref: dict) -> dict:
    """The data-parallel step against the one-process step on the card, by
    the GAN-step gate of `gan_step_card_vs_cpu`: losses within rtol 1e-4;
    each gradient's largest error from the float64 step at most 4 times
    the larger of the one-process card step's and the CPU fp32 step's;
    G's BN running statistics within rtol 1e-5 (atol 1e-6) of the
    one-process step's."""
    for k, v in one["losses"].items():
        if not np.isclose(dp["losses"][k], v, rtol=1e-4, atol=0):
            raise AssertionError(f"DP GAN step: {k} {dp['losses'][k]} vs one process {v}")
    worst = {}
    for k, r in ref["grads"].items():
        err_dp = float((dp["grads"][k] - r).abs().max())
        allowed = 4 * max(float((one["grads"][k] - r).abs().max()),
                          float((cpu["grads"][k] - r).abs().max()))
        if err_dp > allowed:
            raise AssertionError(f"DP GAN step: gradient of {k} off float64 by {err_dp}, "
                                 f"> {allowed}")
        worst[k] = [err_dp, allowed / 4]
    bn = 0.0
    for k, v in one["bn"].items():
        if not np.allclose(dp["bn"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6):
            raise AssertionError(f"DP GAN step: BN statistic {k} differs from one process")
        bn = max(bn, float((dp["bn"][k] - v).abs().max()))
    return {"losses_dp": dp["losses"], "losses_one": one["losses"], "bn_max_abs_diff": bn,
            "grad_max_err_from_float64_dp_vs_allowed": worst, "dp_first_step_s": dp["seconds"],
            "one_first_step_s": one["seconds"], "dp_steady_ms": dp["steady_ms"],
            "one_steady_ms": one["steady_ms"]}


def grid_rank(draws: tuple, case: dict) -> dict:
    """One rank of the parallel phase's 4-rank group on the card: the class
    x swarm runner (make_batched_sharded_discovery_runner on a GRID mesh)
    on the main path's models at GRID_ITERATIONS, then the data-parallel
    GAN step over this rank's swarm-axis pair. Returns its results on the
    CPU, its launches, wall seconds and collective seconds."""
    import torch

    from gan_discovery_pso_tpu_torch.core import PsoConfig
    from gan_discovery_pso_tpu_torch.ops.kernels import KERNELS, SPLIT_KERNELS
    from gan_discovery_pso_tpu_torch.parallel import (
        make_batched_sharded_discovery_runner, make_mesh_2d)
    from gan_discovery_pso_tpu_torch.parallel.launch import spawn
    from gan_discovery_pso_tpu_torch.pso import state_from_positions

    mesh = make_mesh_2d(GRID, ("class", "swarm"))
    models = build_models(mesh.device)
    hp = PsoConfig(n_iterations=GRID_ITERATIONS, n_particles=N_PARTICLES, dim_space=DIM)
    run = make_batched_sharded_discovery_runner(mesh, hp, eps=EPS)
    pos, vel, r1, r2 = (t.to(mesh.device) for t in draws)
    kernels = (*SPLIT_KERNELS, *KERNELS)
    zero_counts(kernels)
    t0 = time.perf_counter()
    final, hist, _ = run(*models, list(range(N_CLASSES)),
                         init_state=state_from_positions(pos, vel, hp.w_inertia), r1=r1, r2=r2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dp = dp_step(case, mesh.device, torch.float32, group=mesh.groups["swarm"],
                 warm=DP_WARM_STEPS)
    return {"g_best": final.g_best_val.cpu(), "g_history": hist.g_best_val.cpu(),
            "positions": final.positions.cpu(), "wall_s": wall,
            "launches": {k.__name__: k.launches for k in kernels},
            "collectives": mesh.collective_stats(), "coords": mesh.coords, "backend": mesh.backend,
            "device": str(mesh.device), "seconds_to_group": spawn.seconds_to_group, "dp": dp}


def parallel_phase(models, device, kernels, card: str, seq_g_best: dict) -> dict:
    """The parallel paths on the one card (placed last, after the timings):
    - `pso-discovery --shard-swarm 2` through the CLI on JAX-format
      checkpoints of the main path's models, 8 classes x 32 particles x 50
      iterations in fp32 parity: the CLI starts 2 ranks on cuda:0 over gloo
      (NCCL refuses two ranks on one card), each swarm split 16 + 16; the
      artifact contract of the sequential run; g_best per class within
      SEQ_TOL of the pipeline phase's sequential run on the same draws;
      per rank B1's halves and B2 50 launches a class, the fused B1 0;
    - the batched sharded runner at world 1 under NCCL in this process,
      bit-equal to the batched runner (the fused B1) on the same draws;
    - 4 ranks on cuda:0 over gloo: the 2 x 2 class x swarm runner at
      GRID_ITERATIONS against the batched runner (g_best within SEQ_TOL:
      cuDNN may sum a batch of 64 images in another order than one of
      256), then the data-parallel GAN step (z 10, f 64, batch 128) on each
      swarm-axis pair against the one-process step (`check_dp_step`).
    Returns each run's launches."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    import gan_discovery_pso_tpu_torch.parallel.launch as launch_module
    from gan_discovery_pso_tpu_torch.core import PsoConfig, gpulock, load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig
    from gan_discovery_pso_tpu_torch.parallel import (
        distributed_initialize_if_needed, make_batched_sharded_discovery_runner, make_mesh)
    from gan_discovery_pso_tpu_torch.parallel.launch import spawn
    from gan_discovery_pso_tpu_torch.pso import (
        PsoHistory, SwarmState, draw_uniforms, make_batched_discovery_runner, swarm_init)

    t_phase = time.perf_counter()
    sets100 = {"trainer_gan.z_dim": DIM, "trainer_pso.dim_space": DIM}
    cfg = load_config(CFG, overrides=sets100)
    classes = list(DataConfig.from_config(cfg.data).iid_classes)
    iters = int(cfg.trainer_pso.n_iterations)
    out = {}

    # 1. the sharded stage through the CLI, which starts its ranks under this
    # process's GPU lease (they inherit it, core/gpulock.py)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_par_"))
    holders = []
    real_spawn = launch_module.spawn

    def spawning(*a, **kw):
        holders.append(gpulock.current_holder())
        return real_spawn(*a, **kw)

    launch_module.spawn = spawning
    try:
        dirs = write_checkpoints(tmp / "upstream", 1, *models)
        run = run_cli(tmp, "sharded", dirs, device, kernels, "--shard-swarm", str(SHARDS),
                      sets=sets100)
        check_artifacts(run, classes, DIM, iters)
    finally:
        launch_module.spawn = real_spawn
        shutil.rmtree(tmp, ignore_errors=True)
    if len(holders) != 1 or not holders[0] or holders[0]["pid"] != os.getpid():
        raise AssertionError(f"sharded: the ranks started under the lease of {holders}, not "
                             "this process's")
    if gpulock.current_holder() is not None:
        raise AssertionError(f"sharded: the lease is still held: {gpulock.current_holder()}")
    text = run["log"]
    backend = re.findall(r"\] (\d+) ranks, backend (\w+): (.*)", text)[-1]
    if backend[1] != "gloo" or backend[2] != ", ".join(
            f"rank {r} on {device}" for r in range(SHARDS)):
        raise AssertionError(f"sharded: ranks {backend}, not gloo with every rank on {device}")
    per_rank = json.loads(re.findall(r"launches per rank: (\[.*\])", text)[-1])
    want = {"swarm_pbest_local": len(classes) * iters, "swarm_move": len(classes) * iters,
            "rescale01_rows": len(classes) * iters, "swarm_update": 0}
    for r, counts in enumerate(per_rank):
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"sharded: rank {r} launched {counts}, not {want}")
    g = check_g_best(run, len(classes))
    g_seq = np.asarray([float(seq_g_best[str(c)]) for c in classes])
    rel = float(np.max(np.abs(g - g_seq) / np.abs(g_seq)))
    if rel > SEQ_TOL:
        raise AssertionError(f"sharded: g_best {g} vs sequential {g_seq}, rtol {rel} > {SEQ_TOL}")
    collective_s = [row["collective_s"] for row in per_rank]
    up_s = log_seconds(text, r"process group up in ([0-9.]+)s")
    class_walls = [float(x) for x in re.findall(r"all-reduces in [0-9.]+s, wall ([0-9.]+)s", text)]
    log(f"parallel: pso-discovery --shard-swarm {SHARDS} (gloo, both ranks on {device}): "
        f"stage {run['wall']:.6f} s (cli.main, rank start-up included), ranks up in "
        f"{up_s:.6f} s, runner wall of {len(classes)} classes {class_walls[-1]:.6f} s, "
        f"collectives {collective_s} s per rank ({100 * max(collective_s) / class_walls[-1]:.1f} "
        f"% of the runner), artifacts {run['artifact_s']:.6f} s; g_best within {rel:.3e} "
        f"(rtol) of the sequential run; launches per rank {per_rank}; ranks started under "
        f"the GPU lease of this process ({holders[0]['holder']}) ({card})")
    out["sharded (rank 0)"] = {k: per_rank[0][k] for k in want}

    # 2. world 1 under NCCL in this process: bit-equal to the fused runner
    hp = PsoConfig(n_iterations=N_ITERATIONS, n_particles=N_PARTICLES, dim_space=DIM)
    rng = torch.Generator(device=device).manual_seed(SEED + 31)
    init = swarm_init(rng, N_CLASSES, N_PARTICLES, DIM, hp.w_inertia, device)
    r1, r2 = draw_uniforms(rng, N_ITERATIONS, N_CLASSES, N_PARTICLES, device)
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    try:
        distributed_initialize_if_needed(f"file://{store}/store", 1, 0, device="cuda")
        mesh = make_mesh(1, "swarm")
        if mesh.backend != "nccl":
            raise AssertionError(f"world 1: backend {mesh.backend}, not nccl")
        sharded = make_batched_sharded_discovery_runner(mesh, hp, eps=EPS, class_axis=None)
        zero_counts(kernels)
        t0 = time.perf_counter()
        got = sharded(*models, list(range(N_CLASSES)), init_state=init, r1=r1, r2=r2)
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - t0
        out["world 1 nccl"] = {k.__name__: k.launches for k in kernels}
        nccl_stats = mesh.collective_stats()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    fused = make_batched_discovery_runner(hp, eps=EPS, device=device)
    zero_counts(kernels)
    t0 = time.perf_counter()
    want_run = fused(*models, list(range(N_CLASSES)), init_state=init, r1=r1, r2=r2)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    for part, names in ((0, SwarmState._fields), (1, PsoHistory._fields)):
        for name, x, y in zip(names, got[part], want_run[part]):
            bits_equal(x.contiguous(), y.contiguous())
    want1 = {"swarm_pbest_local": N_ITERATIONS, "swarm_move": N_ITERATIONS,
             "rescale01_rows": N_ITERATIONS, "swarm_update": 0}
    if {k: out["world 1 nccl"][k] for k in want1} != want1:
        raise AssertionError(f"world 1: launches {out['world 1 nccl']}, not {want1}")
    log(f"parallel: batched sharded runner at world 1 (nccl, {N_CLASSES} x {N_PARTICLES} x "
        f"{N_ITERATIONS}) bit-equal to the batched runner, final state and history: "
        f"{nccl_s:.6f} s vs {fused_s:.6f} s; collectives {nccl_stats}; launches "
        f"{out['world 1 nccl']} ({card})")

    # 3. 4 ranks: the class x swarm runner and the data-parallel GAN step
    rng = torch.Generator(device=device).manual_seed(SEED + 32)
    grid_hp = PsoConfig(n_iterations=GRID_ITERATIONS, n_particles=N_PARTICLES, dim_space=DIM)
    init = swarm_init(rng, N_CLASSES, N_PARTICLES, DIM, grid_hp.w_inertia, device)
    r1, r2 = draw_uniforms(rng, GRID_ITERATIONS, N_CLASSES, N_PARTICLES, device)
    draws = tuple(t.cpu() for t in (init.positions, init.velocities, r1, r2))
    case = dp_step_case(load_config(CFG))
    world = GRID[0] * GRID[1]
    t0 = time.perf_counter()
    ranks = spawn(grid_rank, world, draws, case, device="cuda")
    spawn_s = time.perf_counter() - t0
    batched = make_batched_discovery_runner(grid_hp, eps=EPS, device=device)
    want_final, want_hist, _ = batched(*models, list(range(N_CLASSES)), init_state=init, r1=r1,
                                       r2=r2)
    want_g = want_final.g_best_val.cpu().numpy()
    per_class = N_CLASSES // GRID[0]
    want_grid = {"swarm_pbest_local": GRID_ITERATIONS, "swarm_move": GRID_ITERATIONS,
                 "rescale01_rows": GRID_ITERATIONS, "swarm_update": 0}
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo" or res["device"] != "cuda:0":
            raise AssertionError(f"grid rank {r}: {res['backend']} on {res['device']}")
        if {k: res["launches"][k] for k in want_grid} != want_grid:
            raise AssertionError(f"grid rank {r}: launches {res['launches']}, not {want_grid}")
        if not torch.equal(res["g_best"], ranks[0]["g_best"]):
            raise AssertionError(f"grid rank {r}: g_best differs from rank 0's")
    g = ranks[0]["g_best"].numpy()
    rel_grid = float(np.max(np.abs(g - want_g) / np.abs(want_g)))
    hist_rel = float(np.max(np.abs(ranks[0]["g_history"].numpy() - want_hist.g_best_val.cpu()
                                   .numpy()) / np.abs(want_hist.g_best_val.cpu().numpy())))
    if max(rel_grid, hist_rel) > SEQ_TOL or not np.isfinite(ranks[0]["positions"].numpy()).all():
        raise AssertionError(f"grid: g_best {g} vs batched {want_g} (rtol {rel_grid}, history "
                             f"{hist_rel}) > {SEQ_TOL}")
    out["grid (rank 0)"] = {k: ranks[0]["launches"][k] for k in want_grid}
    log(f"parallel: class x swarm runner on a {GRID[0]} x {GRID[1]} mesh ({world} ranks, "
        f"{ranks[0]['backend']}, {ranks[0]['device']}; {per_class} classes x {N_PARTICLES // GRID[1]} particles a rank, "
        f"{GRID_ITERATIONS} iterations): g_best within {rel_grid:.3e}, history {hist_rel:.3e} "
        f"(rtol) of the batched runner; runner wall per rank "
        f"{[round(x['wall_s'], 6) for x in ranks]} s, collectives per rank "
        f"{[x['collectives'] for x in ranks]}; ranks up in "
        f"{[round(x['seconds_to_group'], 6) for x in ranks]} s, spawn to join {spawn_s:.6f} s; "
        f"launches per rank {[x['launches'] for x in ranks]} ({card})")

    one = dp_step(case, device, torch.float32, warm=DP_WARM_STEPS)
    cpu = dp_step(case, torch.device("cpu"), torch.float32)
    ref = dp_step(case, torch.device("cpu"), torch.float64)
    summary = check_dp_step(ranks[0]["dp"], one, cpu, ref)
    if ranks[0]["dp"]["losses"] != ranks[1]["dp"]["losses"]:
        raise AssertionError("DP GAN step: the pair's ranks report other losses")
    log(f"parallel: data-parallel GAN step over {GRID[1]} ranks ({ranks[0]['backend']}, "
        f"{ranks[0]['device']}; z {case['gen'].gen[0][0].in_channels}, f "
        f"{case['gen'].gen[1][0].out_channels}, batch {case['real'].shape[0]}): "
        f"{json.dumps(summary)} ({card})")
    log(f"parallel phase: {time.perf_counter() - t_phase:.6f} s ({card})")
    return out


EXPORT_BATCH = N_CLASSES * N_PARTICLES  # the exported fitness's batch: the main path's images
GATE_STEPS = 30  # bench.py's GAN loss-trajectory gate (bench.py:515-522)
TRAIN_GATE = 0.25  # mean |loss - loss_fp32| over the GATE_STEPS steps, either loss
REDUCED_LIMIT = "2048"  # images a dataset of the reduced --fast-math runs holds


def run_sweep(kernels, argv: list) -> list:
    """`cli.main(["sweep", ...])` in this process, each leg run by a
    stand-in for `cli.main.dispatch` with the launch counts zeroed just
    before it and read just after: each leg's stage, overrides, wall and
    launches. The GPU lease must be held by this process's sweep during
    every leg and released after."""
    import os

    import torch

    import gan_discovery_pso_tpu_torch.cli.main as cli_module
    from gan_discovery_pso_tpu_torch.core import gpulock

    legs = []
    real = cli_module.dispatch

    def counting(args, *rest):
        if args.stage == "sweep":
            return real(args, *rest)
        holder = gpulock.current_holder()
        zero_counts(kernels)
        t0 = time.perf_counter()
        rc = real(args, *rest)
        torch.cuda.synchronize()
        legs.append({"stage": args.stage, "set": list(args.set[-3:]),
                     "ood_patient": args.ood_patient, "wall_s": time.perf_counter() - t0,
                     "launches": {k.__name__: k.launches for k in kernels}, "holder": holder})
        return rc

    cli_module.dispatch = counting
    try:
        rc = cli_module.main(argv)
    finally:
        cli_module.dispatch = real
    if rc != 0:
        raise AssertionError(f"sweep {argv}: the CLI returned {rc}")
    for leg in legs:
        holder = leg.pop("holder")
        if not holder or holder["pid"] != os.getpid() or holder["holder"] != "cli:sweep":
            raise AssertionError(f"sweep leg {leg['stage']}: the GPU lease is held by "
                                 f"{holder}, not this process's sweep")
    if gpulock.current_holder() is not None:
        raise AssertionError(f"the GPU lease is still held after the sweep: "
                             f"{gpulock.current_holder()}")
    return legs


def export_checks(models, device, kernels, card: str, tmp: Path, dirs: dict) -> tuple:
    """`export-model generator` and `fitness` through the CLI on JAX-format
    checkpoints of the main path's models (z 100, G(64), ResNet-50 over the
    8 IiD classes, batch EXPORT_BATCH), loaded again in this process on the
    card: each within rtol 1e-5 of the runner's fitness and of G (bit-equal
    expected in fp32 parity; the largest gap is reported), one B2 launch
    per call of the fitness artifact and no B1; B2's registered operator
    bit-equal to its plain version at [EXPORT_BATCH, 784] in fp32 and bf16;
    the trace and save seconds, and per-call ms of artifact and runner in
    turns. Returns (report, launches of one artifact call)."""
    import torch

    import gan_discovery_pso_tpu_torch.cli.main as cli_module
    from gan_discovery_pso_tpu_torch.compat.export import load_exported
    from gan_discovery_pso_tpu_torch.core import load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig
    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_rows_op, rescale01_rows_plain
    from gan_discovery_pso_tpu_torch.pso import make_discovery_fitness_dynamic

    classes = sorted(DataConfig.from_config(load_config(CFG).data).iid_classes)
    label = classes[3]
    seconds = {"trace_s": [], "save_s": []}
    real = {"export": torch.export.export, "save": torch.export.save}

    def timed_call(name, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            seconds[key].append(time.perf_counter() - t0)
            return out
        return call

    paths, walls = {}, {}
    torch.export.export, torch.export.save = (timed_call("export", "trace_s"),
                                              timed_call("save", "save_s"))
    try:
        for what in ("generator", "fitness"):
            paths[what] = tmp / "export" / f"{what}.pt2"
            t0 = time.perf_counter()
            rc = cli_module.main([
                "export-model", what, str(paths[what]), "--cfg", str(CFG), "--device",
                str(device), "--path-gan", str(dirs["gan"]), "--path-cnn", str(dirs["cnn"]),
                "--batch", str(EXPORT_BATCH), "--class-label", str(label), "--set",
                f"trainer_gan.z_dim={DIM}", f"trainer_pso.dim_space={DIM}"])
            walls[what] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"export-model {what}: the CLI returned {rc}")
    finally:
        torch.export.export, torch.export.save = real["export"], real["save"]

    rng = torch.Generator(device=device).manual_seed(SEED + 40)
    pos = torch.randn((EXPORT_BATCH, DIM), generator=rng, device=device)
    z = torch.randn((EXPORT_BATCH, DIM, 1, 1), generator=rng, device=device)
    t0 = time.perf_counter()
    fit_art = load_exported(paths["fitness"], device=device)
    gen_art = load_exported(paths["generator"], device=device)
    load_s = time.perf_counter() - t0
    graph_ops = [n.target for n in fit_art.program.graph.nodes if n.op == "call_function"]
    if graph_ops.count(torch.ops.gdpt.rescale01_rows.default) != 1:
        raise AssertionError("fitness artifact: gdpt::rescale01_rows is not one node of the graph")
    runner = make_discovery_fitness_dynamic(*models, eps=EPS)
    idx = classes.index(label)
    want = runner(pos, idx)
    zero_counts(kernels)
    got = fit_art.call(pos)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    if launches != {k: int(k == "rescale01_rows") for k in launches}:
        raise AssertionError(f"fitness artifact: one call launched {launches}, not B2 once")
    with fp32_parity(), torch.no_grad():
        g_want = models[0](z)
    g_got = gen_art.call(z)
    report = {"trace_s": seconds["trace_s"], "save_s": seconds["save_s"],
              "export_model_wall_s": walls, "load_s": load_s,
              "artifact_bytes": {k: p.stat().st_size for k, p in paths.items()}}
    for what, a, b in (("fitness", got, want), ("generator", g_got, g_want)):
        gap = float((a.float() - b.float()).abs().max())
        if a.shape != b.shape or not torch.allclose(a, b, rtol=1e-5, atol=0):
            raise AssertionError(f"{what} artifact vs the runner: max |diff| {gap}")
        report[what] = {"bit_equal": bool(torch.equal(a, b)), "max_abs_gap": gap}
    # B2 through the operator, against its plain version
    imgs = g_want.reshape(EXPORT_BATCH, -1).contiguous()
    for out_bf16 in (False, True):
        dtype = torch.bfloat16 if out_bf16 else torch.float32
        bits_equal(rescale01_rows_op(imgs, out_bf16), rescale01_rows_plain(imgs, dtype))
    report["op_bit_equal_to_plain"] = [EXPORT_BATCH, imgs.shape[1]]
    ms, runner_ms = in_turns(lambda: fit_art.call(pos), lambda: runner(pos, idx))
    report["fitness_ms_per_call"] = {"artifact": ms, "runner": runner_ms, "batch": EXPORT_BATCH}
    log(f"export-model ({card}): " + json.dumps(report))
    return report, launches


def round_trip_torch(dcgan_models: Path, tmp: Path) -> dict:
    """`export-torch` of a card-trained best_g to the reference's `.tar`,
    then `convert-torch` of that back: every tensor of G bit-equal to the
    checkpoint's, and the `.tar` loads into a Generator strictly."""
    import numpy as np
    import torch

    import gan_discovery_pso_tpu_torch.cli.main as cli_module
    from gan_discovery_pso_tpu_torch.compat import load_reference_checkpoint
    from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, restore_tree
    from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef

    best = dcgan_models / "best_g.msgpack"
    tar, back = tmp / "round_trip" / "best_g.tar", tmp / "round_trip" / "best_g.msgpack"
    for argv in (["export-torch", str(best), "generator", str(tar)],
                 ["convert-torch", str(tar), "generator", str(back)]):
        if cli_module.main(argv) != 0:
            raise AssertionError(f"{argv[0]} returned non-zero")
    orig = restore_tree(load_pytree(best))
    conv = restore_tree(load_pytree(back))
    pairs = ((orig["state"]["gen_params"], conv["params"]),
             (orig["state"]["gen_state"], conv["state"]))
    n = 0

    def same(a, b, path=""):
        nonlocal n
        if isinstance(a, dict):
            if a.keys() != b.keys():
                raise AssertionError(f"round trip: keys of {path} differ")
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
            return
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"round trip: {path} differs")
        n += 1

    for a, b in pairs:
        same(a, b)
    sd = load_reference_checkpoint(tar)
    z_dim, f2 = sd["gen.0.0.weight"].shape[:2]
    Generator(GeneratorDef(z_dim, 1, f2 // 2)).load_state_dict(sd, strict=True)
    epoch = torch.load(tar, weights_only=True)["epoch"]
    return {"tensors_bit_equal": n, "tar_epoch": epoch, "z_dim": int(z_dim)}


def trace_check(models, device, kernels, tmp: Path) -> dict:
    """`core.trace` around one main-path run: the Chrome trace it writes
    names B1's and B2's kernels (those of `kernels`)."""
    from gan_discovery_pso_tpu_torch.core import trace

    names = [k.__name__ for k in kernels]

    with trace(tmp / "trace"):
        drive_main_path(models, device, None, kernels)
    files = list((tmp / "trace").glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace: {len(files)} trace files")
    text = files[0].read_text()
    found = {name: sum(text.count(k) for k in KERNEL_NAMES[name])
             for name in ("swarm_update", "rescale01_rows") if name in names}
    if '"traceEvents"' not in text or not all(found.values()):
        raise AssertionError(f"trace: kernel names missing from the trace: {found}")
    return {"file_bytes": files[0].stat().st_size, "kernel_name_hits": found}


def gan_step_gate(device, data: dict) -> dict:
    """bench.py's GAN gate (bench.py:505-522) on the port: GATE_STEPS steps
    at the shipped widths (z 10, f 64, batch 128) from one seeded state, one
    batch of the synthetic digits and the same draws, under fp32 parity,
    under `tf32_math()` and with `compute_dtype=torch.bfloat16`: mean
    |loss - loss_fp32| over the steps, each loss, at most TRAIN_GATE for
    TF32 and bf16; then 5 steady steps of each profiled (wall ms, device
    idle share)."""
    import copy
    import itertools

    import numpy as np
    import torch

    from gan_discovery_pso_tpu_torch.core import AdamConfig, load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig
    from gan_discovery_pso_tpu_torch.data import epoch_batches, load_mnist
    from gan_discovery_pso_tpu_torch.models import DiscriminatorDef, GeneratorDef
    from gan_discovery_pso_tpu_torch.ops import fp32_parity, tf32_math
    from gan_discovery_pso_tpu_torch.train.common import make_optimizer
    from gan_discovery_pso_tpu_torch.train.dcgan import (
        GanTrainState, gan_init, make_gan_train_step)

    cfg = load_config(CFG, overrides=data)
    data_cfg = DataConfig.from_config(cfg.data)
    bs = int(cfg.trainer_gan.batch_size)
    adam = AdamConfig.from_config(cfg.trainer_gan.optimizer)
    base = gan_init(torch.Generator().manual_seed(SEED + 50),
                    GeneratorDef(int(cfg.trainer_gan.z_dim), 1,
                                 int(cfg.model_gan.network.units_gen)),
                    DiscriminatorDef(1, int(cfg.model_gan.network.units_disc)), adam,
                    device=device)
    ds = load_mnist(data["data.data_dir"], "train", classes=data_cfg.iid_classes,
                    drange=(-1, 1), device=device)
    batches = [x for x, _y in itertools.islice(
        epoch_batches(ds, bs, torch.Generator().manual_seed(SEED)), 7)]
    real = batches[0]
    modes = {"fp32": (None, fp32_parity), "tf32": (None, tf32_math),
             "bf16": (torch.bfloat16, fp32_parity)}

    def fresh(dtype):
        g, d = copy.deepcopy(base.gen), copy.deepcopy(base.disc)
        st = GanTrainState(g, d, make_optimizer(adam, list(g.parameters())),
                           make_optimizer(adam, list(d.parameters())))
        return make_gan_train_step(st, compute_dtype=dtype)

    traj, prof = {}, {}
    for mode, (dtype, precision) in modes.items():
        step, rows = fresh(dtype), []
        with precision():
            for i in range(GATE_STEPS):
                m = step(real, torch.Generator(device=device).manual_seed(SEED + 60 + i))
                rows.append(torch.stack([m["loss_gen"], m["loss_disc"]]))
        traj[mode] = torch.stack(rows).cpu().numpy()
        if not np.isfinite(traj[mode]).all():
            raise AssertionError(f"GAN gate: {mode} losses not finite")
        rng = torch.Generator(device=device).manual_seed(SEED + 22)
        with precision():
            prof[mode] = profile_steps(fresh(dtype), [(x, rng) for x in batches])
    gate = {mode: [float(v) for v in np.abs(traj[mode] - traj["fp32"]).mean(axis=0)]
            for mode in ("tf32", "bf16")}
    for mode, diffs in gate.items():
        if max(diffs) > TRAIN_GATE:
            raise AssertionError(f"GAN gate: {mode} mean |loss - loss_fp32| {diffs} > "
                                 f"{TRAIN_GATE}")
    return {"mean_abs_loss_diff_gen_disc": gate, "gate": TRAIN_GATE, "steps": GATE_STEPS,
            "final_losses": {m: [float(v) for v in t[-1]] for m, t in traj.items()},
            "profiled_steps": {m: {k: p[k] for k in ("wall_ms_per_step", "device_busy_ms",
                                                     "device_idle_share") if k in p}
                               for m, p in prof.items()}}


def first_losses(run: dict) -> dict:
    """Each loss series of the stage's overall_history.pkl: its first value
    and its last (all of them finite)."""
    import numpy as np

    with open(run["reports"] / "general" / "overall_history.pkl", "rb") as f:
        history = pickle.load(f)
    out = {}
    for key, values in history.items():
        if isinstance(values, dict) or "loss" not in key:
            continue
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            continue
        if not np.isfinite(arr).all():
            raise AssertionError(f"{run['label']}: {key} not finite")
        out[key] = [float(arr[0]), float(arr[-1])]
    return out


def fast_math_runs(device, kernels, card: str, tmp: Path, dirs: dict, pso_interim: Path,
                   data: dict) -> dict:
    """One reduced run (1 epoch, --limit REDUCED_LIMIT) of cae, cnn-multipatient,
    inverter (pix_rec), regularize-inverter (on that inverter's encoder) and
    vqvae (G z 100 as the decoder, the pipeline phase's particles as the
    codebook) in fp32 parity and under --fast-math: finite losses, no port
    kernel launched, checkpoints that load and run in fp32 parity, the first
    (and last) values of each loss series side by side, the stage's wall.
    No limit is set on the gap, as the JAX package sets none."""
    import numpy as np
    import torch

    from gan_discovery_pso_tpu_torch.core import load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig
    from gan_discovery_pso_tpu_torch.data import load_mnist
    from gan_discovery_pso_tpu_torch.ops import fp32_parity
    from gan_discovery_pso_tpu_torch.pipelines import (
        load_cae, load_cnn, load_encoder, load_gan, load_vqvae)

    classes = list(DataConfig.from_config(load_config(CFG, overrides=data).data).iid_classes)
    x = load_mnist(data["data.data_dir"], "test", classes=classes, drange=(-1, 1),
                   device=device).images[:64]
    x01 = (x + 1) / 2
    vq_sets = {"data.iid_classes": classes, "data.ood_classes": [1, 5]}
    vq_cfg = load_config(VQ_CFG, overrides={**data, **vq_sets})
    gen100 = load_gan(dirs["gan"], device=device)
    report = {}
    for mode, flags in (("fp32_parity", ()), ("fast_math", ("--fast-math",))):
        def stage(name, *args, keep=None, cfg=CFG, **extra):
            run = cli_stage(tmp, f"{name}_{mode}", name, device, kernels, *flags, "--epochs",
                            "1", "--limit", REDUCED_LIMIT, *args, sets={**data, **extra},
                            keep=keep, cfg=cfg)
            if any(run["launches"].values()):
                raise AssertionError(f"{name} ({mode}): launches {run['launches']}; no port "
                                     "kernel is on this stage's path")
            run["label"] = f"{name} ({mode})"
            report.setdefault(name, {})[mode] = {"stage_s": run["wall"],
                                                 "losses_first_last": first_losses(run)}
            return run

        cae = stage("cae")
        multi = stage("cnn-multipatient", keep="run_cnn_multipatient")
        inv = stage("inverter", "--path-gan", str(dirs["gan"]), **{
            "trainer_gan.z_dim": DIM, "trainer_inverter.training_function": "pix_rec"})
        reg = cli_stage(tmp, f"regularize-inverter_{mode}", "regularize-inverter", device,
                        kernels, *flags, "--limit", REDUCED_LIMIT, "--path-gan",
                        str(dirs["gan"]), "--path-inverter", str(inv["model"]),
                        sets={**data, "trainer_gan.z_dim": DIM})
        reg["label"] = f"regularize-inverter ({mode})"
        report["regularize-inverter"] = {**report.get("regularize-inverter", {}), mode: {
            "stage_s": reg["wall"], "losses_first_last": first_losses(reg)}}
        vq = stage("vqvae", "--path-gan", str(dirs["gan"]), "--path-pso", str(pso_interim),
                   cfg=VQ_CFG, **vq_sets)
        # the checkpoints, loaded and run in fp32 parity
        encoder, decoder = load_cae(cae["model"], device=device)
        model, mdef = multi["value"]
        with fp32_parity(), torch.no_grad():
            outs = {"cae": decoder(encoder(x01)),
                    "cnn-multipatient": load_cnn(multi["model"], mdef, device=device)(x01),
                    "inverter": load_encoder(inv["model"], device=device)(x)}
            with np.load(reg["interim"] / "inverted_z.npz") as f:
                outs["regularize-inverter"] = gen100(torch.as_tensor(f["z"], device=device))
            outs["vqvae"] = load_vqvae(vq["model"], vq_cfg, device=device).encoder(x, False)
        for name, t in outs.items():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} ({mode}): the checkpoint's output in fp32 parity "
                                     "is not finite")
    log(f"--fast-math runs beside fp32 parity ({card}): " + json.dumps(report))
    return report


def remainder_phase(models, device, kernels, card: str, upstream: Path,
                    pso_interim: Path, sets=()) -> dict:
    """The CLI's remaining entry points and `--fast-math` for training, at
    full width:
    1. `export-model fitness` and `generator` (`export_checks`);
    2. `sweep --latent-dims 10 --stages dcgan pso-discovery` (1 dcgan epoch
       on the assessor phase's CAE and battery; pso-discovery sequential,
       8 classes x 32 x 50, on the z-10 G the dcgan leg writes and the
       seeded ResNet-50): B2 10 launches in the dcgan leg, B1 and B2 400
       each in the pso-discovery leg; then the per-patient sweep of patient
       1 x both controls (pso-inverter, 1 fine-tune epoch at --limit
       REDUCED_LIMIT, 256 x 50): B1 and B2 50 each a leg; every leg under
       this process's GPU lease (`run_sweep`);
    3. `export-torch` then `convert-torch` of the dcgan leg's card-trained G
       (`round_trip_torch`);
    4. a `core.trace` file naming B1 and B2 (`trace_check`);
    5. `--fast-math` for training (ROADMAP A18): the GAN loss-trajectory
       gate under TF32 and bf16 (`gan_step_gate`) and the reduced
       --fast-math runs (`fast_math_runs`).
    Returns each run's launches. `sets` adds config overrides (a rehearsal on
    the CPU cuts the data and the swarms)."""
    import tempfile

    from gan_discovery_pso_tpu_torch.core import load_config
    from gan_discovery_pso_tpu_torch.core.config import DataConfig

    t_phase = time.perf_counter()
    out, report = {}, {}
    names = [k.__name__ for k in kernels]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rest_") as tmp_name:
        tmp = Path(tmp_name)
        dirs = write_checkpoints(tmp / "upstream", 1, *models)
        _enc, dirs["inv"] = write_encoder(tmp / "upstream", 1, device)
        data = {"data.data_dir": str(tmp / "no_mnist"), **dict(sets)}
        cfg = load_config(CFG, overrides=data)
        classes = DataConfig.from_config(cfg.data).iid_classes
        iters = int(cfg.trainer_pso.n_iterations)
        inv_iters = int(cfg.trainer_pso_inverter.n_iterations)
        extra = [f"{k}={v}" for k, v in data.items()]

        # 1. export-model
        report["export"], out["export fitness (one artifact call)"] = export_checks(
            models, device, kernels, card, tmp, dirs)

        # 2. the sweeps
        def roots(label):
            return [*extra, *(f"data.{k}_dir={tmp / label / k}"
                              for k in ("reports", "model", "interim"))]

        def expected(**counts):
            return {n: counts.get(n, 0) for n in names}

        t0 = time.perf_counter()
        legs = run_sweep(kernels, [
            "sweep", "--cfg", str(CFG), "--device", str(device), "--latent-dims", "10",
            "--stages", "dcgan", "pso-discovery", "--epochs", "1",
            "--path-cae", str(upstream / "cae"), "--path-classifiers",
            str(upstream / "classifiers"),
            "--path-gan", str(tmp / "latent" / "model" / "mnist" / "00001--dcgan"),
            "--path-cnn", str(dirs["cnn"]), "--set", *roots("latent")])
        latent_s = time.perf_counter() - t0
        n_eval = -(-int(cfg.trainer_gan.batch_size) * 100 // 1280)  # the sampler's chunks
        want = {"dcgan": expected(rescale01_rows=n_eval),
                "pso-discovery": expected(swarm_update=len(classes) * iters,
                                          rescale01_rows=len(classes) * iters)}
        if [leg["stage"] for leg in legs] != ["dcgan", "pso-discovery"]:
            raise AssertionError(f"latent sweep legs {legs}")
        for leg in legs:
            if leg["launches"] != want[leg["stage"]]:
                raise AssertionError(f"sweep leg {leg['stage']} (z 10): launches "
                                     f"{leg['launches']}, not {want[leg['stage']]}")
            out[f"sweep {leg['stage']} z10"] = leg["launches"]
        t0 = time.perf_counter()
        patient_legs = run_sweep(kernels, [
            "sweep", "--cfg", str(CFG), "--device", str(device), "--patients", str(PATIENT),
            "--epochs", "1", "--limit", REDUCED_LIMIT, "--path-gan", str(dirs["gan"]),
            "--path-cnn", str(dirs["cnn"]), "--path-inverter", str(dirs["inv"]), "--set",
            f"trainer_gan.z_dim={DIM}", *roots("patients")])
        patient_s = time.perf_counter() - t0
        controls = [leg["set"][-1].split("=")[1] for leg in patient_legs]
        if controls != ["optimize_in_training", "optimize_out_training"]:
            raise AssertionError(f"per-patient sweep legs {patient_legs}")
        for leg, control in zip(patient_legs, controls):
            want_inv = expected(swarm_update=inv_iters, rescale01_rows=inv_iters)
            if leg["stage"] != "pso-inverter" or leg["launches"] != want_inv:
                raise AssertionError(f"per-patient leg {leg}: not pso-inverter with {want_inv}")
            out[f"sweep pso-inverter patient {PATIENT} {control}"] = leg["launches"]
        report["sweep"] = {"latent_dim_10": {"wall_s": latent_s, "legs": legs},
                           f"patient_{PATIENT}": {"wall_s": patient_s, "legs": patient_legs}}
        log(f"sweeps ({card}): " + json.dumps(report["sweep"]))

        # 3. the torch round trip of the card-trained G
        report["torch_round_trip"] = round_trip_torch(
            tmp / "latent" / "model" / "mnist" / "00001--dcgan", tmp)
        log("convert-torch / export-torch: " + json.dumps(report["torch_round_trip"]))

        # 4. a trace naming the kernels
        report["trace"] = trace_check(models, device, kernels, tmp)
        log("trace: " + json.dumps(report["trace"]))

        # 5. --fast-math for training (ROADMAP A18)
        report["gan_gate"] = gan_step_gate(device, data)
        log(f"GAN loss-trajectory gate ({card}): " + json.dumps(report["gan_gate"]))
        report["fast_math"] = fast_math_runs(device, kernels, card, tmp, dirs, pso_interim,
                                             data)
    log(f"remainder phase: {time.perf_counter() - t_phase:.6f} s ({card})")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "gan_discovery_pso_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: gan_discovery_pso_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gan_discovery_pso_tpu_torch.ops.kernels import (
        KERNELS, SPLIT_KERNELS, _build, rescale01_rows, rescale01_rows_plain, swarm_move,
        swarm_move_plain, swarm_pbest_local, swarm_pbest_local_plain, swarm_update,
        swarm_update_plain)

    card = card_line()
    log(f"card: {card}")
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: {so.name}")

    models = build_models(device)
    swarm_rec, swarm_to_time = check_swarm_update(models, device)
    rescale_rec, rescale_to_time = check_rescale(models, device)
    split_recs, split_to_time = check_split(models, device)
    records = [swarm_rec, rescale_rec, *split_recs]

    evals = N_CLASSES * N_PARTICLES * N_ITERATIONS
    results = {}
    for label, dtype in (("fp32", None), ("fp32", None), ("bf16", torch.bfloat16),
                         ("bf16", torch.bfloat16)):
        final, hist, seconds, launches = drive_main_path(models, device, dtype, KERNELS)
        for name, count in launches.items():
            if count != N_ITERATIONS:
                raise AssertionError(f"{label}: {name} launched {count} times, "
                                     f"not {N_ITERATIONS}")
        g = final.g_best_val
        if not (bool(torch.isfinite(g).all()) and bool((g >= EPS).all())
                and bool((g <= 1 + EPS).all())):
            raise AssertionError(f"{label}: g_best out of [eps, 1+eps]: {g.tolist()}")
        if tuple(hist.fitness.shape) != (N_CLASSES, N_ITERATIONS, N_PARTICLES):
            raise AssertionError(f"{label}: fitness history {tuple(hist.fitness.shape)}")
        results.setdefault(label, []).append((g.clone(), seconds, launches))
        log(f"main path {label}: {seconds * 1e3:.1f} ms, {evals / seconds:.0f} evals/s "
            f"({card}); launches {launches}; g_best {g.tolist()}")
    (g32a, _, launches32), (g32b, s32, _) = results["fp32"]
    g16, s16, _ = results["bf16"][1]
    if not torch.equal(g32a, g32b):
        raise AssertionError(f"two fp32 runs differ: {g32a.tolist()} vs {g32b.tolist()}")
    gate = float((g32b - g16).abs().max())
    if gate > GATE:
        raise AssertionError(f"bf16 gate: max |g32 - g16| = {gate} > {GATE}")
    log(f"fp32 runs identical; bf16 gate max |g32 - g16| = {gate:.3e} <= {GATE}")
    log(f"evals/s warm: fp32 {evals / s32:.0f}, bf16 {evals / s16:.0f} ({card})")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pso_") as keep:
        pso_interim, upstream = Path(keep) / "batched", Path(keep) / "assessor"
        dim2_interim, ood_interim = Path(keep) / "dim2", Path(keep) / "ood"
        seq_g_best = {}
        pipeline_launches = pipeline_phase(models, device, KERNELS, card,
                                           keep_interim=pso_interim, keep_dim2=dim2_interim,
                                           keep_g_best=seq_g_best)
        pipeline_launches.update(inverter_phase(models, device, KERNELS, card,
                                                keep_interim=ood_interim))
        pipeline_launches.update(inverter_training_phase(models, device, KERNELS, card,
                                                         pso_interim))
        pipeline_launches.update(assessor_eval_phase(models, device, KERNELS, card,
                                                     keep_upstream=upstream))
        pipeline_launches.update(gan_vqvae_phase(models, device, KERNELS, card, upstream,
                                                 pso_interim))
        pipeline_launches.update(analysis_claro_phase(device, KERNELS, card, pso_interim,
                                                      dim2_interim, ood_interim))
        prof = profile_main_path(models, device, KERNELS)
        log("profile fp32 main path: " + json.dumps(prof))
        log("profile bf16 main path: "
            + json.dumps(profile_main_path(models, device, KERNELS, torch.bfloat16)))
        diff = check_against_cpu(models, device, KERNELS)
        log(f"small input: card path (kernels) agrees with the CPU path (plain) to {diff:.3e}")
        # the standalone timings come after the main path's numbers, so that
        # those are taken before this process has run any profiler session
        time_kernel(swarm_rec, swarm_update, swarm_update_plain, swarm_to_time)
        time_kernel(rescale_rec, rescale01_rows, rescale01_rows_plain, rescale_to_time)
        time_kernel(split_recs[0], swarm_pbest_local, swarm_pbest_local_plain,
                    split_to_time["swarm_pbest_local"])
        time_kernel(split_recs[1], swarm_move, swarm_move_plain, split_to_time["swarm_move"])
        # the parallel phase after every profiler session: in a run where it
        # came before them, three sessions of B1 each lost their first 15
        # kernel events
        all_kernels = (*KERNELS, *SPLIT_KERNELS)
        pipeline_launches.update(parallel_phase(models, device, all_kernels, card, seq_g_best))
        pipeline_launches.update(remainder_phase(models, device, all_kernels, card, upstream,
                                                 pso_interim))

    for rec in records:
        # the split halves' path is the sharded stage: rank 0's count there
        rec["launches"] = (launches32[rec["name"]] if rec["name"] in launches32
                           else pipeline_launches["sharded (rank 0)"][rec["name"]])
        rec["pipeline_launches"] = {run: counts.get(rec["name"], "not counted")
                                    for run, counts in pipeline_launches.items()}
        rec["device_us_per_launch"] = prof.get("port_kernels_us_per_launch", {}).get(
            rec["name"], "not measured")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
