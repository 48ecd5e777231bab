"""Process groups, meshes and the few collectives of the port (counterpart of
`gan_discovery_pso_tpu/parallel/mesh.py`).

The JAX package lays a `Mesh` of devices over axes ("swarm", "data",
"class") and lets GSPMD or `shard_map` place the collectives. Here every
rank is a process with a `torch.distributed` process group, and a `Mesh`
says where this rank sits on each axis and which process group joins it
with the ranks that differ from it only on that axis. Ranks are laid out
row-major, as `np.array(devices).reshape(shape)` lays out the JAX mesh.

- Device: rank r runs on `cuda:{r % device_count}`, or where the caller
  names (`device="cpu"`, or one card for every rank).
- Backend: NCCL when every rank has a card of its own; gloo when ranks
  share a card or run on the CPU (NCCL refuses two ranks on one card).
  Nothing falls back to the CPU: a CUDA request on a host without CUDA
  raises (`core/device.py`).
- Collectives: `all_reduce` (MIN, SUM) and `broadcast` only, the ones gloo
  carries for CUDA tensors (the sharded swarm needs only the first; the
  CLI broadcasts its run id, the data-parallel GAN step its initial
  state); a collective the backend refuses raises its error. A mesh of one
  process with no process group runs none.

`shard_leading` and `replicated` (JAX `:38,43`) have no counterpart: a
rank holds its own rows as a plain tensor, and `parallel/swarm_sharding.py`
says which (`swarm_state_sharding`). `gather_rows` rebuilds a whole array
from every rank's rows, bit for bit, with one all-reduce SUM of their
bits: each element has one nonzero term, so even a -0.0 or a NaN's payload
comes through.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import time

import torch
import torch.distributed as dist

from gan_discovery_pso_tpu_torch.core.device import resolve_device

INIT_TIMEOUT = datetime.timedelta(minutes=10)
_OPS = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}


def rank_device(device, rank: int) -> torch.device:
    """Rank `rank`'s device: `cuda:{rank % device_count}` for a CUDA
    request without an index, else the device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def choose_backend(device, world: int) -> str:
    """NCCL when the ranks get a card each (a CUDA request without an
    index and at least `world` cards), else gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def distributed_initialize_if_needed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> bool:
    """Join this process to a process group; True when it has more than one
    rank (JAX `:46`).

    Configuration comes from the arguments or, when omitted, the
    GDPT_COORDINATOR / GDPT_NUM_PROCESSES / GDPT_PROCESS_ID variables. The
    coordinator is `host:port` (TCP), a URL (`tcp://...`, `file://...`),
    or "" for `env://` (MASTER_ADDR, RANK and WORLD_SIZE, as torchrun sets
    them). No configuration: nothing happens, False. A group the caller or
    torchrun already started is taken as it is. The rank's device is made
    current (`rank_device`); the backend is `choose_backend`'s."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        coordinator_address = os.environ.get("GDPT_COORDINATOR")
    if coordinator_address is None:
        return False
    if coordinator_address == "":
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        if num_processes is None:
            num_processes = int(os.environ["GDPT_NUM_PROCESSES"])
        if process_id is None:
            process_id = int(os.environ["GDPT_PROCESS_ID"])
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(choose_backend(device, num_processes),
                            init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=INIT_TIMEOUT)
    return num_processes > 1


@dataclasses.dataclass
class Mesh:
    """This rank's place on a mesh of `shape` over `axis_names`.

    `groups[axis]` is the process group of the ranks that share every other
    coordinate with this one; None on a mesh of one process that has no
    process group. Each collective is counted and timed: on the card by
    two CUDA events on the current stream around it, which nothing waits
    for until `collective_stats` reads them, so the queue stays as
    asynchronous as without a mesh; on the CPU by the host's clock."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    rank: int
    device: torch.device
    backend: str | None
    groups: dict
    world_group: object = None
    stats: dict = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "seconds": 0.0})
    _events: list = dataclasses.field(default_factory=list, repr=False)

    def size(self, axis: str | None = None) -> int:
        """Ranks along `axis`, or in the whole mesh."""
        if axis is None:
            return math.prod(self.shape)
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self.coords[self.axis_names.index(axis)]

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis: str | None = None):
        """`t` reduced in place over `axis` (or the whole mesh) by "min" or
        "sum"; returns t. A mesh without process groups leaves t alone."""
        group = self.world_group if axis is None else self.groups[axis]
        if group is None:
            return t
        if t.is_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dist.all_reduce(t, _OPS[op], group=group)
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            dist.all_reduce(t, _OPS[op], group=group)
            self.stats["seconds"] += time.perf_counter() - t0
        self.stats["all_reduce"] += 1
        return t

    def collective_stats(self) -> dict:
        """{'all_reduce': count, 'seconds': their time} so far. Reads the
        card's pending events, waiting for the last of them: call it once
        per unit of work (a class), not per iteration."""
        if self._events:
            self._events[-1][1].synchronize()
            self.stats["seconds"] += sum(a.elapsed_time(b) for a, b in self._events) / 1e3
            self._events.clear()
        return dict(self.stats)


def _mesh(shape: tuple, axis_names: tuple, device) -> Mesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a process group "
                             "(distributed_initialize_if_needed or torchrun)")
        dev = resolve_device(device)
        return Mesh(tuple(axis_names), tuple(shape), (0,) * len(shape), 0, dev, None,
                    dict.fromkeys(axis_names))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a process group of {world}")
    coords, rest = [], rank
    for size in reversed(shape):
        coords.append(rest % size)
        rest //= size
    coords = tuple(reversed(coords))
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups = {}
    for a, name in enumerate(axis_names):
        if shape[a] == world:
            groups[name] = dist.group.WORLD
            continue
        # every rank creates every group of the axis, in the same order
        other = [i for i in range(len(shape)) if i != a]
        for fixed in itertools.product(*(range(shape[i]) for i in other)):
            base = sum(c * strides[i] for i, c in zip(other, fixed))
            ranks = [base + k * strides[a] for k in range(shape[a])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    return Mesh(tuple(axis_names), tuple(shape), coords, rank, rank_device(device, rank),
                dist.get_backend(), groups, dist.group.WORLD)


def make_mesh(n_devices: int | None = None, axis_name: str = "swarm", *,
              device=None) -> Mesh:
    """1-D mesh over every rank of the process group (JAX `:23`);
    `n_devices`, where given, must be its size. Without a process group, a
    mesh of one rank that runs no collective."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((n_devices,), (axis_name,), device)


def make_mesh_2d(shape: tuple[int, int], axis_names=("data", "swarm"), *,
                 device=None) -> Mesh:
    """2-D mesh of shape[0] x shape[1] ranks, row-major (JAX `:31`)."""
    return _mesh(tuple(shape), tuple(axis_names), device)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    raise ValueError(f"gather_rows: unsupported dtype {t.dtype}")


def _from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return bits != 0
    return bits.view(dtype)


def gather_blocks(parts, mesh: Mesh, axis: str | None = None) -> list:
    """Whole arrays from every rank's blocks, in one all-reduce SUM over
    `axis` (or the whole mesh). `parts`: (local block, its index into the
    whole array (a tuple of slices), the whole shape, whether this rank
    adds it). Ranks that hold a replica of a block let one of them add it.
    float32, int32 and bool arrays come back bit for bit."""
    flats, metas = [], []
    for local, index, shape, adds in parts:
        whole = torch.zeros(shape, dtype=torch.int32, device=mesh.device)
        if adds:
            whole[index] = _bits(local.to(mesh.device))
        flats.append(whole.reshape(-1))
        metas.append((shape, local.dtype))
    flat = mesh.all_reduce(torch.cat(flats), "sum", axis)
    out, at = [], 0
    for shape, dtype in metas:
        n = math.prod(shape)
        out.append(_from_bits(flat[at:at + n].reshape(shape), dtype))
        at += n
    return out


def gather_rows(local: torch.Tensor, offset: int, rows: int, mesh: Mesh, dim: int = 0,
                axis: str | None = None) -> torch.Tensor:
    """The whole array whose rows [offset, offset + local.shape[dim]) along
    `dim` this rank holds, every rank's rows gathered over `axis`."""
    shape = list(local.shape)
    shape[dim] = rows
    index = [slice(None)] * local.dim()
    index[dim] = slice(offset, offset + local.shape[dim])
    return gather_blocks([(local, tuple(index), tuple(shape), True)], mesh, axis)[0]
