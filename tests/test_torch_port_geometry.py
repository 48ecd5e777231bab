"""The pure-Python launch choices beside the port's CUDA kernels (tile and
team sizes, the float4 or scalar paths) and the kernel library's build hash.
The kernels run only on the card (chip_smoke.py); what decides how they are
launched runs here."""

import re
import shutil
from collections import Counter

import pytest
import torch

from gan_discovery_pso_tpu_torch.ops.kernels import _build
from gan_discovery_pso_tpu_torch.ops.kernels.rescale import (
    MAX_WARPS_PER_CTA,
    TARGET_WARPS,
    rescale_geometry,
    rescale_vector,
)
from gan_discovery_pso_tpu_torch.ops.kernels.swarm_update import (
    CTAS_PER_SM,
    WARPS,
    swarm_geometry,
    vector_path,
)

H100_SMS = 132
SWARM_SHAPES = [(8, 32), (8, 256), (3, 13), (1, 32), (32, 32), (2, 37), (1, 4096), (1, 1),
                (1, 7), (4, 9), (65535, 2)]
RESCALE_SHAPES = [(256, 784), (9, 300), (5, 301), (4096, 784), (1024, 784), (2048, 784),
                  (1, 784), (300, 4096), (4, 65536), (3, 4099), (1, 1)]


def _kernel_constant(source, pattern):
    return int(re.search(pattern, (_build.CSRC / source).read_text()).group(1))


def _swarm_launch(b, n, sms):
    """(rows per CTA, tiles per swarm) as csrc/swarm_update.cu's entry
    launches them from the helper's tile."""
    rows = swarm_geometry(b, n, sms)
    return rows, -(-n // rows)


def _rescale_launch(n, f):
    """(short path, team, rows per CTA, CTAs) as csrc/rescale.cu's entry
    launches them: rows of at most kShortMaxF floats in registers, with the
    helper's team; longer rows a CTA each."""
    if f > _kernel_constant("rescale.cu", r"constexpr int kShortMaxF = (\d+);"):
        return False, 1, 1, n
    team, rows = rescale_geometry(n)
    return True, team, rows, -(-n // rows)


def _swarm_rows_visited(n, rows, tiles):
    """Rows each (tile, warp) of csrc/swarm_update.cu's move visits:
    row0 = tile*rows, rows row0 + warp, + WARPS, ... below min(n, row0 + rows)."""
    seen = Counter()
    for tile in range(tiles):
        row0 = tile * rows
        for warp in range(WARPS):
            seen.update(range(row0 + warp, min(n, row0 + rows), WARPS))
    return seen


@pytest.mark.parametrize("b,n", SWARM_SHAPES)
def test_swarm_tiles_cover_every_particle_row_once(b, n):
    rows, tiles = _swarm_launch(b, n, H100_SMS)
    assert rows >= WARPS  # at least one row per warp
    assert (tiles - 1) * rows < n <= tiles * rows  # no empty tile
    assert _swarm_rows_visited(n, rows, tiles) == Counter(range(n))


@pytest.mark.parametrize("b,n", SWARM_SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_swarm_cta_count_fills_the_card_when_the_rows_allow(b, n, sms):
    rows, tiles = _swarm_launch(b, n, sms)
    assert rows % WARPS == 0  # every warp walks as many rows
    most_tiles = -(-n // WARPS)  # one row per warp
    wanted = -(-CTAS_PER_SM * sms // b)  # tiles per swarm
    if most_tiles >= wanted:
        assert tiles >= wanted
        assert tiles <= 2 * wanted or rows == WARPS  # no smaller tiles than it takes
    else:
        assert (rows, tiles) == (WARPS, most_tiles)


def test_swarm_geometry_at_the_paths_shapes():
    assert _swarm_launch(8, 32, H100_SMS) == (8, 4)  # main path: 32 CTAs
    assert _swarm_launch(1, 32, H100_SMS) == (8, 4)  # B = 1 runner
    assert _swarm_launch(32, 32, H100_SMS) == (8, 4)  # stacked x4: 128 CTAs
    assert _swarm_launch(1, 4096, H100_SMS) == (8, 512)  # the Pallas range
    assert _swarm_launch(1, 8192, H100_SMS) == (24, 342)


@pytest.mark.parametrize("d,offset,vec_d", [(100, 0, True), (1024, 0, True), (13, 0, False),
                                            (7, 0, False), (100, 1, False), (100, 4, True),
                                            (1030, 0, False), (2048, 0, True), (100, 2, False),
                                            (100, 8, True), (4, 3, False)])
def test_swarm_vector_path_over_d(d, offset, vec_d):
    """float4 rows need d % 4 == 0 and 16-byte aligned bases: an offset
    view (`offset` floats into its storage) keeps them only at offset % 4 == 0."""
    base = torch.empty(offset + 2 * 3 * d)
    pos = base[offset:].view(2, 3, d)
    aligned = torch.empty(16)
    assert vector_path(d, (pos.data_ptr(), aligned.data_ptr())) is vec_d
    assert base.data_ptr() % 16 == 0
    # an output buffer off alignment takes the scalar rows too
    assert not vector_path(d, (aligned.data_ptr(), aligned.data_ptr() + 4))


def _rescale_rows_visited(n, team, rows, ctas):
    """Rows each (CTA, warp) of csrc/rescale.cu's short path holds:
    row = cta*rows + warp / team, for CTAs of team*rows warps; or one CTA a
    row on the long path."""
    seen = Counter()
    for cta in range(ctas):
        for warp in range(team * rows):
            row = cta * rows + warp // team
            if row < n and warp % team == 0:  # one count per team
                seen[row] += 1
    return seen


@pytest.mark.parametrize("n,f", RESCALE_SHAPES)
def test_rescale_covers_every_image_row_once(n, f):
    short, team, rows, ctas = _rescale_launch(n, f)
    assert short is (f <= 4096)  # 28x28 and 64x64 images sit in registers
    assert team * rows <= MAX_WARPS_PER_CTA  # at most 256 threads a CTA
    assert team == 1 or rows == 1  # a team of several warps is the whole CTA
    if not short:
        assert (team, rows, ctas) == (1, 1, n)
    assert _rescale_rows_visited(n, team, rows, ctas) == Counter(range(n))


@pytest.mark.parametrize("n,f", RESCALE_SHAPES)
def test_rescale_cta_and_warp_rule(n, f):
    short, team, rows, ctas = _rescale_launch(n, f)
    if not short:
        return
    # the largest team that keeps n * team within TARGET_WARPS
    assert team == MAX_WARPS_PER_CTA or n * team * 2 > TARGET_WARPS
    assert n * team <= TARGET_WARPS or team == 1
    if team > 1:
        assert (rows, ctas) == (1, n)  # a CTA a row
    else:  # a warp a row, 8 rows a CTA: at least 256 CTAs, about 2 per SM
        assert rows == MAX_WARPS_PER_CTA and ctas >= 2 * 128


def test_rescale_geometry_at_the_paths_shapes():
    assert _rescale_launch(256, 784) == (True, 8, 1, 256)  # main path: a CTA a row
    assert _rescale_launch(1024, 784) == (True, 4, 1, 1024)
    assert _rescale_launch(4096, 784) == (True, 1, 8, 512)  # a warp a row
    assert _rescale_launch(4, 256 * 256) == (False, 1, 1, 4)  # CLARO slices


@pytest.mark.parametrize("f,x_offset,out_dtype,vec", [
    (784, 0, torch.float32, True), (784, 0, torch.bfloat16, True),
    (301, 0, torch.float32, True),  # odd F: float4 body, scalar head and tail
    (301, 301, torch.float32, False),  # an offset view: x 4 bytes past alignment
    (300, 300, torch.bfloat16, True),  # offset of a whole float4
    (301, 2, torch.bfloat16, False)])
def test_rescale_vector_or_scalar_walk(f, x_offset, out_dtype, vec):
    x = torch.empty(x_offset + 3 * f)[x_offset:].view(3, f)
    out = torch.empty((3, f), dtype=out_dtype)
    assert x.is_contiguous()
    assert rescale_vector(x.data_ptr(), out.data_ptr(), out.element_size()) is vec
    # an output that is not aligned to 4 of its elements takes the scalar walk too
    assert not rescale_vector(x.data_ptr(), out.data_ptr() + out.element_size(),
                              out.element_size())


@pytest.mark.parametrize("source,pattern,python", [
    ("rescale.cu", r"__launch_bounds__\((\d+)\) rescale_short_kernel", 32 * MAX_WARPS_PER_CTA),
    ("swarm_update.cu", r"constexpr int kThreads = (\d+);", 32 * WARPS)])
def test_python_geometry_matches_the_kernel_sources(source, pattern, python):
    """The threads a CTA may hold, as the helpers count them in warps."""
    assert _kernel_constant(source, pattern) == python


def test_every_file_under_csrc_enters_the_library_hash(tmp_path, monkeypatch):
    """An edited source or header rebuilds; every .cu file is compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    files = sorted(p.name for p in csrc.iterdir() if p.is_file())
    assert "common.cuh" in files
    assert sorted(_build.SOURCES) == sorted(f for f in files if f.endswith(".cu"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    seen = {_build.library_path()}
    for name in files:
        path = csrc / name
        original = path.read_bytes()
        path.write_bytes(original + b"\n")
        seen.add(_build.library_path())
        path.write_bytes(original)
        assert _build.library_path() in seen
    assert len(seen) == len(files) + 1
