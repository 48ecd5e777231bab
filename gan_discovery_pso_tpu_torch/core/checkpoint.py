"""Checkpoints in flax's msgpack format, written and read in plain Python
(counterpart of `gan_discovery_pso_tpu/core/checkpoint.py:25-168`).

The JAX package writes every checkpoint with
`flax.serialization.msgpack_serialize`: msgpack with `strict_types=True`,
arrays as ext type 1 (a packed `(shape, dtype name, C-order bytes)`), numpy
scalars as ext type 3, and arrays over 2**30 bytes split into a
`__msgpack_chunked_array__` dict. This module implements that format itself
(no flax, no msgpack package), so the port reads the `best_g.msgpack` and
`model.msgpack` files of JAX runs and writes files byte-equal to flax's for
the same tree.

- Writes are atomic: a tmp file, fsync, then `os.replace`.
- `bfloat16` arrays come back as `torch.bfloat16` tensors (numpy has no
  such dtype); every other array comes back as numpy.
- `restore_tree` keeps `{mean, var}` BN leaves as dicts, the form
  `compat/weights.py` reads.
- A tree of ranks (`save_pytree(..., mesh=)`): leaves that are `RowShard`s
  (a rank's rows of a sharded array) are gathered onto every rank of the
  mesh, bit for bit, and its rank 0 alone writes: the file is byte-equal to
  the one-process save of the whole arrays, as the JAX package's
  `save_pytree` gathers a cross-process array (`tests/test_multihost.py`).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# -- writer ------------------------------------------------------------------


def _array_bytes(arr) -> bytes:
    """flax `_ndarray_to_bytes`: msgpack of (shape, dtype name, C bytes)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            shape, name = tuple(arr.shape), "bfloat16"
            data = arr.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()
        else:
            return _array_bytes(arr.detach().cpu().numpy())
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack_header(out, 0x90, 0xDC, 0xDD, 3)
    _pack_header(out, 0x90, 0xDC, 0xDD, len(shape))
    for s in shape:
        _pack_int(out, int(s))
    _pack_str(out, name)
    _pack_bin(out, data)
    return bytes(out)


def _pack_header(out: bytearray, fix: int, c16: int, c32: int, n: int) -> None:
    """Array (0x90) or map (0x80) header of n items."""
    if n <= 0x0F:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", c16, n)
    else:
        out += struct.pack(">BI", c32, n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    n = len(b)
    if n <= 0x1F:
        out.append(0xA0 | n)
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xD9, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xDA, n)
    else:
        out += struct.pack(">BI", 0xDB, n)
    out += b


def _pack_bin(out: bytearray, b: bytes) -> None:
    n = len(b)
    if n <= 0xFF:
        out += struct.pack(">BB", 0xC4, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC5, n)
    else:
        out += struct.pack(">BI", 0xC6, n)
    out += b


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT:
        out += struct.pack(">Bb", _FIXEXT[n], code)
    elif n <= 0xFF:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def _pack(out: bytearray, obj) -> None:
    """msgpack with strict types: exact bool/int/float/str/bytes/dict/list;
    arrays and numpy scalars as flax's ext types; anything else refused."""
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is bytes:
        _pack_bin(out, obj)
    elif t is str:
        _pack_str(out, obj)
    elif t is dict:
        _pack_header(out, 0x80, 0xDE, 0xDF, len(obj))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif t is list:
        _pack_header(out, 0x90, 0xDC, 0xDD, len(obj))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object "
                        "(tuples and NamedTuples go through _plainify first)")


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def _chunk(arr) -> dict:
    """flax `_chunk`: a flat array split into pieces of MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / (arr.element_size() if isinstance(arr, torch.Tensor)
                                        else arr.dtype.itemsize)))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, flat.shape[0], size))}}


def _sorted_tree(node):
    """Every dict's keys in sorted order: flax's `jax.tree_util.tree_map`
    copy rebuilds dicts so before packing."""
    if isinstance(node, dict):
        return {k: _sorted_tree(node[k]) for k in sorted(node)}
    if isinstance(node, list):
        return [_sorted_tree(v) for v in node]
    return node


def _chunk_large(node):
    """flax `_chunk_array_leaves_in_place`, without mutating: array leaves
    that are dict values (or the whole tree) and exceed MAX_CHUNK_SIZE."""
    if isinstance(node, dict):
        return {k: (_chunk(v) if isinstance(v, (np.ndarray, torch.Tensor))
                    and _nbytes(v) > MAX_CHUNK_SIZE else _chunk_large(v))
                for k, v in node.items()}
    if isinstance(node, (np.ndarray, torch.Tensor)) and _nbytes(node) > MAX_CHUNK_SIZE:
        return _chunk(node)
    return node


def msgpack_serialize(tree) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize(tree)` gives for a
    tree of dicts, lists, python scalars, numpy arrays and scalars (and
    torch tensors, packed as the numpy arrays they hold): dict keys sorted,
    large arrays chunked, then msgpack with strict types."""
    out = bytearray()
    _pack(out, _chunk_large(_sorted_tree(tree)))
    return bytes(out)


# -- reader ------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _array_from_bytes(data)[()]
        raise ValueError(f"msgpack ext type {code} is not a flax array (1) or "
                         "numpy scalar (3)")

    def read(self):
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fixed:
            return self.unpack(fixed[c])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        if c in sized:
            n = self.unpack(sized[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str_(n)
            if c <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map_(n)
        if c in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (c - 0xD4))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _array_from_bytes(data: bytes):
    """flax `_ndarray_from_bytes`; bfloat16 comes back as a torch tensor."""
    r = _Reader(data, raw=True)
    shape, name, buf = r.read()
    shape = tuple(shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape).copy()


def _unchunk_tree(node):
    """flax `_unchunk_array_leaves_in_place`, without mutating."""
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            parts = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            if isinstance(parts[0], torch.Tensor):
                return torch.cat(parts).reshape(shape)
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def msgpack_restore(blob: bytes):
    """The tree `flax.serialization.msgpack_restore(blob)` gives, with
    writable numpy arrays and bfloat16 as torch tensors."""
    r = _Reader(blob)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk_tree(tree)


# -- pytrees -----------------------------------------------------------------


def _plainify(node):
    """NamedTuple → dict, tuple/list → list, tensors → numpy (bf16 stays a
    tensor: numpy has no bfloat16); other leaves as they are."""
    if hasattr(node, "_fields"):
        return {f: _plainify(getattr(node, f)) for f in node._fields}
    if isinstance(node, dict):
        return {k: _plainify(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plainify(v) for v in node]
    if isinstance(node, torch.Tensor) and node.dtype != torch.bfloat16:
        return node.detach().cpu().numpy()
    return node


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A rank's rows [offset, offset + local.shape[dim]) along `dim` of an
    array of `rows` rows that the ranks of a mesh hold between them."""

    local: torch.Tensor
    offset: int
    rows: int
    dim: int = 0


def _gather_shards(node, mesh):
    from gan_discovery_pso_tpu_torch.parallel.mesh import gather_rows

    if isinstance(node, RowShard):
        return gather_rows(node.local, node.offset, node.rows, mesh, node.dim).cpu()
    if hasattr(node, "_fields"):
        return type(node)(*(_gather_shards(v, mesh) for v in node))
    if isinstance(node, dict):
        return {k: _gather_shards(v, mesh) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_gather_shards(v, mesh) for v in node)
    return node


def save_pytree(path: str | Path, tree: Any, mesh=None) -> Path | None:
    """Atomically write a pytree of arrays/scalars/dicts as flax msgpack;
    NamedTuples go out as dicts keyed by field name. With a `mesh`
    (`parallel.Mesh`), every rank calls this with its `RowShard`s; rank 0
    writes the gathered tree and returns the path, the others None."""
    if mesh is not None:
        tree = _gather_shards(tree, mesh)
        if mesh.rank != 0:
            return None
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = msgpack_serialize(_plainify(tree))
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX
    return path


def load_pytree(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def restore_tree(node):
    """A loaded checkpoint as a tree of dicts, lists and numpy arrays;
    `{mean, var}` BN leaves stay dicts."""
    if isinstance(node, dict):
        return {k: restore_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [restore_tree(v) for v in node]
    return node


class Checkpointer:
    """Per-run checkpoint files with the reference's stems:
    `checkpoint_<tag>.msgpack` overwritten per epoch
    (reference src/utils/util_dcgan.py:225-238), `best_<tag>.msgpack`
    (:303-314), and bare state saves."""

    def __init__(self, model_dir: str | Path):
        self.model_dir = Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)

    def save_every_epoch(self, tag: str, epoch: int, state: Any, loss=None) -> Path:
        payload = {"epoch": int(epoch), "state": state,
                   "loss": None if loss is None else float(loss)}
        return save_pytree(self.model_dir / f"checkpoint_{tag}.msgpack", payload)

    def save_best(self, tag: str, epoch: int, state: Any, loss=None) -> Path:
        payload = {"epoch": int(epoch), "state": state,
                   "loss": None if loss is None else float(loss)}
        return save_pytree(self.model_dir / f"best_{tag}.msgpack", payload)

    def save_state_dict(self, name: str, state: Any) -> Path:
        """Bare state save, as `torch.save(model.state_dict(), 'x.pt')`
        (reference src/inverter/utils_ae/util_inverter.py:290)."""
        return save_pytree(self.model_dir / f"{name}.msgpack", state)

    def load(self, filename: str) -> Any:
        return load_pytree(self.model_dir / filename)

    def try_load(self, filename: str) -> Any | None:
        """The file's tree, or None where it does not exist."""
        p = self.model_dir / filename
        if not p.exists():
            return None
        return load_pytree(p)
