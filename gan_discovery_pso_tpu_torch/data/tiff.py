"""Baseline TIFF read and write without PIL (it stands in for PIL's
`Image.open` at `gan_discovery_pso_tpu/data/medical.py:102-105` and
`Image.fromarray(x, mode="F").save(..., format="TIFF")` at :252-256).

What it reads: uncompressed baseline TIFF, little- or big-endian, the
first image of the file, in strips (any RowsPerStrip) or one strip, one
sample per pixel, as uint8, int16, uint16, int32 or float32 (CT slices are
16-bit). Compressed or tiled files are refused with a message that names
the tag. What it writes: one uncompressed little-endian strip of one
grayscale channel in any of those dtypes; float32 is what PIL's mode `F`
writes, and what the CLARO export writes.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# (SampleFormat, BitsPerSample) -> numpy dtype; SampleFormat 1 = unsigned
# integer, 2 = signed integer, 3 = IEEE float
_DTYPES = {(1, 8): np.uint8, (2, 16): np.int16, (1, 16): np.uint16,
           (2, 32): np.int32, (3, 32): np.float32}
# field type -> (struct code, bytes per value)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          16: ("Q", 8)}
_COMPRESSION = {2: "CCITT RLE", 5: "LZW", 6: "old JPEG", 7: "JPEG", 8: "Deflate",
                32773: "PackBits", 32946: "Deflate"}
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 277, 278, 279
PLANAR, TILE_WIDTH, TILE_OFFSETS, SAMPLE_FORMAT = 284, 322, 324, 339


def _tags(buf: bytes, order: str) -> dict:
    """The first IFD's tags as {tag: tuple of values}."""
    (ifd,) = struct.unpack_from(order + "I", buf, 4)
    (n,) = struct.unpack_from(order + "H", buf, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count, inline = struct.unpack_from(order + "HHI4s", buf, ifd + 2 + 12 * i)
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        data = inline if nbytes <= 4 else buf[struct.unpack(order + "I", inline)[0]:][:nbytes]
        tags[tag] = struct.unpack_from(order + code * count, data)
    return tags


def read_tiff(path: str | Path) -> np.ndarray:
    """The first image of a baseline uncompressed TIFF as a [H, W] array of
    its own dtype."""
    buf = Path(path).read_bytes()
    order = {b"II": "<", b"MM": ">"}.get(buf[:2])
    if order is None or struct.unpack_from(order + "H", buf, 2)[0] != 42:
        raise ValueError(f"{path}: not a TIFF file (BigTIFF is not read either)")
    tags = _tags(buf, order)
    compression = tags.get(COMPRESSION, (1,))[0]
    if compression != 1:
        name = _COMPRESSION.get(compression, "unknown")
        raise ValueError(f"{path}: Compression (tag 259) = {compression} ({name}); only "
                         "uncompressed TIFF is read")
    if TILE_WIDTH in tags or TILE_OFFSETS in tags:
        raise ValueError(f"{path}: a tiled TIFF (TileWidth, tag 322); only strips are read")
    samples = tags.get(SAMPLES, (1,))[0]
    if samples != 1:
        raise ValueError(f"{path}: SamplesPerPixel (tag 277) = {samples}; only one sample "
                         "per pixel is read")
    w, h = tags[WIDTH][0], tags[LENGTH][0]
    bits, fmt = tags.get(BITS, (1,))[0], tags.get(SAMPLE_FORMAT, (1,))[0]
    dtype = _DTYPES.get((fmt, bits))
    if dtype is None:
        raise ValueError(f"{path}: BitsPerSample (tag 258) = {bits} with SampleFormat "
                         f"(tag 339) = {fmt} is not read (uint8, int16, uint16, int32 or "
                         "float32)")
    dt = np.dtype(dtype).newbyteorder(order)
    data = b"".join(buf[o:o + c] for o, c in zip(tags[STRIP_OFFSETS], tags[STRIP_COUNTS]))
    need = w * h * dt.itemsize
    if len(data) < need:
        raise ValueError(f"{path}: the strips hold {len(data)} bytes, the image needs {need}")
    return np.frombuffer(data[:need], dt).reshape(h, w).astype(dtype)


def write_tiff(path: str | Path, image: np.ndarray) -> Path:
    """[H, W] uint8, int16, uint16, int32 or float32 → an uncompressed
    little-endian TIFF of one strip."""
    a = np.ascontiguousarray(image)
    key = next((k for k, v in _DTYPES.items() if np.dtype(v) == a.dtype), None)
    if a.ndim != 2 or key is None:
        raise ValueError(f"write_tiff takes a 2-D uint8, int16, uint16, int32 or float32 "
                         f"array, not {a.dtype} {a.shape}")
    fmt, bits = key
    h, w = a.shape
    pixels = a.astype(a.dtype.newbyteorder("<")).tobytes()
    entries = [(WIDTH, 4, w), (LENGTH, 4, h), (BITS, 3, bits), (COMPRESSION, 3, 1),
               (PHOTOMETRIC, 3, 1), (STRIP_OFFSETS, 4, 8), (SAMPLES, 3, 1),
               (ROWS_PER_STRIP, 4, h), (STRIP_COUNTS, 4, len(pixels)), (PLANAR, 3, 1),
               (SAMPLE_FORMAT, 3, fmt)]
    ifd = 8 + len(pixels) + len(pixels) % 2  # the IFD starts on a word boundary
    out = [struct.pack("<2sHI", b"II", 42, ifd), pixels, b"\0" * (len(pixels) % 2),
           struct.pack("<H", len(entries))]
    for tag, typ, value in entries:
        inline = struct.pack("<H2x" if typ == 3 else "<I", value)
        out.append(struct.pack("<HHI", tag, typ, 1) + inline)
    out.append(struct.pack("<I", 0))
    path = Path(path)
    path.write_bytes(b"".join(out))
    return path
