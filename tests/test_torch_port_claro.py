"""The port's CLARO data layer against the JAX package's on the CPU: the
xlsx manifests (each XML member byte-equal to the JAX writer's), the TIFF
codec against PIL, the resize against `jax.image.resize` and PIL, the CT
slice chain, the sliding-window loader, the patient export and
`claro-preprocess` through both CLIs on the same files, and the
augmentation fed the draws JAX makes from its key.

Tolerances: xlsx members byte-equal and read-back columns equal; TIFF
arrays equal; the resize within 2e-6 of the input's range (the worst case,
97 → 31 against PIL, is 1.6e-6); a preprocessed slice within 5e-6 (the
resize's error on a ±1500 HU scan, over the 2000 HU scale); the augmented
images within 2e-5 (an image in [0, 1]: XLA and torch round cos, sin and
the elastic blur differently, which moves a sample coordinate by ~1e-5).
Tiny sizes: 64 x 64 slices (96 x 96 scans), 2 patients."""

import importlib.util
import struct
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch
from PIL import Image

from gan_discovery_pso_tpu.cli.main import main as jax_cli_main
from gan_discovery_pso_tpu.data import augment as jaug
from gan_discovery_pso_tpu.data import medical as jmed
from gan_discovery_pso_tpu.data import xlsx as jxlsx
from gan_discovery_pso_tpu_torch.cli.main import main as cli_main
from gan_discovery_pso_tpu_torch.data import augment, medical, tiff, xlsx
from gan_discovery_pso_tpu_torch.ops.resize import resize_bilinear

REPO = Path(__file__).resolve().parents[1]
CFG = "configs/claro_preprocess.yaml"
DATASET = "claro_prospettivo"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- xlsx ------------------------------------------------------------------------------

MANIFESTS = {
    "boxes": {"img ID": ["PAT1_0", "PAT1_1", "PAT2_0"],
              "max_box": ["[20, 25, 70, 60]", "[1, 2, 3, 4]", "[0, 0, 9, 9]"]},
    "mixed": {"id": [1.0, 12.0, None], "name": ["a<&>\"'", "b", "ü"],
              "score": [0.5, float("nan"), np.float32(0.25)],
              "n": list(np.arange(3, dtype=np.int64)), "inf": [float("inf"), 1, -2.5]},
    "ragged": {"a": [1.0], "b": ["x", "y", "z"], "c": []},
}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_xlsx_members_byte_equal_and_read_back(tmp_path, name):
    cols = MANIFESTS[name]
    ours = xlsx.write_xlsx(tmp_path / "port.xlsx", cols)
    theirs = jxlsx.write_xlsx(tmp_path / "jax.xlsx", cols)
    with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist()
        for member in a.namelist():
            assert a.read(member) == b.read(member), member
    for path in (ours, theirs):
        assert xlsx.read_xlsx(path) == jxlsx.read_xlsx(path)
        assert xlsx.read_manifest(path) == jxlsx.read_manifest(path)


def test_xlsx_csv_and_errors_match_jax(tmp_path):
    csv = tmp_path / "m.csv"
    csv.write_text("img ID,max_box\nA_1,\"[1, 2, 3, 4]\"\nB_2,\"[5, 6, 7, 8]\"\n")
    assert xlsx.read_manifest(csv) == jxlsx.read_manifest(csv)
    p = xlsx.write_xlsx(tmp_path / "dup.xlsx", {"label": ["a"], "other": ["b"]})
    with zipfile.ZipFile(p) as zf:
        contents = {n: zf.read(n) for n in zf.namelist()}
    contents["xl/worksheets/sheet1.xml"] = contents["xl/worksheets/sheet1.xml"].replace(
        b"<t>other</t>", b"<t>label</t>")
    with zipfile.ZipFile(p, "w") as zf:
        for n, data in contents.items():
            zf.writestr(n, data)
    for reader in (xlsx.read_xlsx, jxlsx.read_xlsx):
        with pytest.raises(ValueError, match="duplicate header"):
            reader(p)


# -- TIFF ------------------------------------------------------------------------------

DTYPES = [np.uint8, np.int16, np.uint16, np.int32, np.float32]


def _scan(dtype, shape=(37, 53), seed=0):
    rng = np.random.RandomState(seed)
    lo, hi = {np.uint8: (0, 255), np.uint16: (0, 65535)}.get(dtype, (-1500, 1500))
    return rng.uniform(lo, hi, shape).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiff_written_by_the_port_reads_in_pil(tmp_path, dtype):
    a = _scan(dtype)
    p = tiff.write_tiff(tmp_path / "a.tif", a)
    np.testing.assert_array_equal(np.asarray(Image.open(p)).astype(dtype), a)
    np.testing.assert_array_equal(tiff.read_tiff(p), a)
    assert tiff.read_tiff(p).dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiff_written_by_pil_reads_in_the_port(tmp_path, dtype):
    a = _scan(dtype, seed=1)
    Image.fromarray(a).save(tmp_path / "a.tif")
    np.testing.assert_array_equal(tiff.read_tiff(tmp_path / "a.tif"),
                                  np.asarray(Image.open(tmp_path / "a.tif")))
    np.testing.assert_array_equal(tiff.read_tiff(tmp_path / "a.tif").astype(dtype), a)


def _multi_strip(path, a, rows):
    """A little-endian float32 TIFF of `rows` rows a strip (offsets and
    counts stored out of line)."""
    strips = [a[r:r + rows].astype("<f4").tobytes() for r in range(0, len(a), rows)]
    n = len(strips)
    data_at = 8
    offsets, pos = [], data_at
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    arrays_at = pos
    ifd_at = arrays_at + 8 * n
    entries = [(256, 4, 1, a.shape[1]), (257, 4, 1, a.shape[0]), (258, 3, 1, 32),
               (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, n, arrays_at), (277, 3, 1, 1),
               (278, 4, 1, rows), (279, 4, n, arrays_at + 4 * n), (339, 3, 1, 3)]
    out = [struct.pack("<2sHI", b"II", 42, ifd_at), *strips,
           struct.pack(f"<{n}I", *offsets), struct.pack(f"<{n}I", *map(len, strips)),
           struct.pack("<H", len(entries))]
    for tag, typ, count, value in entries:
        inline = (struct.pack("<H2x", value) if typ == 3 and count == 1
                  else struct.pack("<I", value))
        out.append(struct.pack("<HHI", tag, typ, count) + inline)
    out.append(struct.pack("<I", 0))
    Path(path).write_bytes(b"".join(out))


def test_tiff_strips_big_endian_and_refusals(tmp_path):
    a = _scan(np.float32, (29, 11), seed=2)
    _multi_strip(tmp_path / "strips.tif", a, rows=4)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "strips.tif")), a)
    np.testing.assert_array_equal(tiff.read_tiff(tmp_path / "strips.tif"), a)
    be = _scan(np.uint16, seed=3).astype(">u2")
    Image.fromarray(be).save(tmp_path / "be.tif")
    assert (tmp_path / "be.tif").read_bytes()[:2] == b"MM"
    np.testing.assert_array_equal(tiff.read_tiff(tmp_path / "be.tif"), be.astype(np.uint16))
    Image.fromarray(a, mode="F").save(tmp_path / "lzw.tif", compression="tiff_lzw")
    with pytest.raises(ValueError, match=r"Compression \(tag 259\) = 5 \(LZW\)"):
        tiff.read_tiff(tmp_path / "lzw.tif")
    tiled = bytearray(tiff.write_tiff(tmp_path / "t.tif", a).read_bytes())
    at = tiled.find(struct.pack("<HH", 278, 4))  # RowsPerStrip → TileWidth
    tiled[at:at + 2] = struct.pack("<H", 322)
    (tmp_path / "t.tif").write_bytes(bytes(tiled))
    with pytest.raises(ValueError, match="tag 322"):
        tiff.read_tiff(tmp_path / "t.tif")
    with pytest.raises(ValueError, match="float32"):
        tiff.write_tiff(tmp_path / "f64.tif", a.astype(np.float64))


# -- resize ----------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(512, 256), (96, 64), (60, 256), (28, 64), (97, 31),
                                     (33, 33), (64, 17), (45, 30)])
def test_resize_matches_jax_and_pil(src, dst):
    a = np.random.RandomState(src + dst).uniform(-1000, 1000, (src, src)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(a), dst).numpy()
    tol = 2e-6 * (a.max() - a.min())
    for want in (np.asarray(jax.image.resize(jnp.asarray(a), (dst, dst), "linear")),
                 np.asarray(jax.image.resize(jnp.asarray(a), (dst, dst), "bilinear")),
                 np.asarray(Image.fromarray(a, mode="F").resize((dst, dst), Image.BILINEAR))):
        assert float(np.abs(got - want).max()) <= tol
    batch = resize_bilinear(torch.from_numpy(np.stack([a, -a]))[:, None], dst)
    assert tuple(batch.shape) == (2, 1, dst, dst)
    np.testing.assert_array_equal(batch[0, 0].numpy(), got)


# -- the CT slice chain --------------------------------------------------------------


@pytest.mark.parametrize("box,perc", [([30, 40, 90, 80], 0.5), ([-5, 10, 40, 100], 0.0),
                                      ([0, 0, 96, 96], 0.5), ([70, 20, 90, 95], 0.25)])
def test_box_crop_and_slice_match_jax(box, perc):
    scan = np.random.RandomState(0).uniform(-1500, 1500, (96, 96))
    assert medical.square_box(box, perc) == jmed.square_box(box, perc)
    np.testing.assert_array_equal(medical.crop_box(scan, box, perc), jmed.crop_box(scan, box, perc))
    np.testing.assert_array_equal(medical.normalize01(scan), jmed.normalize01(scan))
    for clip, scale in ((medical.ClipSpec(-1000, 1000), medical.ClipSpec(-1000, 1000)),
                        (None, None), (medical.ClipSpec(-200, 300), None)):
        jclip = jmed.ClipSpec(*clip) if clip else None
        jscale = jmed.ClipSpec(*scale) if scale else None
        got = medical.preprocess_ct_slice(scan, 64, box=box, clip=clip, scale=scale,
                                          perc_border=perc, device="cpu")
        want = jmed.preprocess_ct_slice(scan, 64, box=box, clip=jclip, scale=jscale,
                                        perc_border=perc)
        assert got.shape == want.shape == (1, 64, 64) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_slice_loader_and_sliding_window_match_jax(tmp_path):
    """.mat (with a NaN), .tif and .png slices, both directory layouts and
    numeric ids; the port resizes on the device where JAX calls PIL."""
    cfg_data = {"channel": 1, "image_size": 32, "nan_cutoff": 0.5,
                "rescale_minus_1_plus_1": True}
    img_dir = tmp_path / "sw" / "1" / "32" / "0.5"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(2)
    manifest = {"id": [], "id_slice": [], "label": []}
    for i, pid in enumerate(("P1", 12.0)):
        arr = rng.uniform(-1000, 1000, (48, 48)).astype(np.float32)
        arr[0, 0] = np.nan
        sio.savemat(img_dir / f"{medical._norm_id(pid)}_{i}.mat", {"img": arr})
        manifest["id"].append(pid)
        manifest["id_slice"].append(float(i))
        manifest["label"].append(float(i % 2))
    got = medical.load_sliding_window_dataset(manifest, tmp_path / "sw", cfg_data, device="cpu")
    want = jmed.load_sliding_window_dataset(manifest, tmp_path / "sw", cfg_data)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.patient_ids == want.patient_ids == ("P1", "12")
    assert got.slice_ids == want.slice_ids == ("0", "1")
    aerts = tmp_path / "sw" / "1" / "32"
    tiff.write_tiff(aerts / "P1_0.tif", rng.rand(40, 40).astype(np.float32))
    flat = {"id": ["P1"], "id_slice": ["0"], "label": [0]}
    np.testing.assert_allclose(
        medical.load_sliding_window_dataset(flat, tmp_path / "sw", cfg_data, flavor="aerts",
                                            extension=".tif", device="cpu").images,
        jmed.load_sliding_window_dataset(flat, tmp_path / "sw", cfg_data, flavor="aerts",
                                         extension=".tif").images, rtol=0, atol=1e-5)
    png = tmp_path / "x.png"
    Image.fromarray((rng.rand(20, 20) * 255).astype(np.uint8)).save(png)
    np.testing.assert_array_equal(medical.load_slice_image(png), jmed.load_slice_image(png))
    np.testing.assert_allclose(medical.slice_loader(png, 16, device="cpu"),
                               jmed.slice_loader(png, 16), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="manifest row 0"):
        medical.load_sliding_window_dataset({"id": [1.0], "id_slice": [5.0], "label": [None]},
                                            tmp_path / "sw", cfg_data, device="cpu")


@pytest.mark.parametrize("entry", ["preprocess_ct_slice", "slice_loader",
                                   "load_sliding_window_dataset", "prepare_patient_dataset",
                                   "draw_augment"])
def test_data_entry_without_device_raises_on_a_host_without_cuda(tmp_path, monkeypatch, entry):
    """The slices are resized on the card, and the draws land there, unless
    the caller names a device; a host without CUDA raises rather than
    quietly running them on the CPU (every slice here is already at its
    size, so none would need a resize)."""
    img = np.random.RandomState(3).uniform(-1000, 1000, (16, 16)).astype(np.float32)
    cfg_data = {"channel": 1, "image_size": 16, "nan_cutoff": 0.5}
    sw = tmp_path / "sw" / "1" / "16" / "0.5"
    sw.mkdir(parents=True)
    sio.savemat(sw / "P1_0.mat", {"img": img})
    (tmp_path / "raw" / "D" / "P1" / "images").mkdir(parents=True)
    tiff.write_tiff(tmp_path / "raw" / "D" / "P1" / "images" / "P1_0.tif", img)
    calls = {
        "preprocess_ct_slice": lambda: medical.preprocess_ct_slice(img, 16),
        "slice_loader": lambda: medical.slice_loader(sw / "P1_0.mat", 16),
        "load_sliding_window_dataset": lambda: medical.load_sliding_window_dataset(
            {"id": ["P1"], "id_slice": ["0"], "label": [0]}, tmp_path / "sw", cfg_data),
        "prepare_patient_dataset": lambda: medical.prepare_patient_dataset(
            tmp_path / "raw", "D", ["P1_0"], 16),
        "draw_augment": lambda: augment.draw_augment(
            2, 16, 16, augment.AugmentConfig(), torch.Generator().manual_seed(0)),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def _write_claro(root: Path, n_slices=3, size=96, boxed=None):
    """2 patients of int16 HU slices written by the port's TIFF writer,
    patients_info and box manifests; returns the slice ids."""
    rng = np.random.RandomState(1)
    ids = []
    for pid in ("PAT1", "PAT2"):
        d = root / "raw" / DATASET / pid / "images"
        d.mkdir(parents=True, exist_ok=True)
        for s in range(n_slices):
            sid = f"{pid}_{s}"
            tiff.write_tiff(d / f"{sid}.tif",
                            rng.uniform(-1500, 1500, (size, size)).astype(np.int16))
            ids.append(sid)
    info = root / "interim" / DATASET
    info.mkdir(parents=True, exist_ok=True)
    xlsx.write_xlsx(info / f"patients_info_{DATASET}.xlsx",
                    {"image": [f"imgs\\{sid}.tif" for sid in ids]})
    boxed = ids[:-1] if boxed is None else boxed
    xlsx.write_xlsx(root / "boxes.xlsx", {
        "img ID": boxed,
        "max_box": [f"[{10 + i}, {20 + 2 * i}, {70 + i}, {60 + i}]" for i in range(len(boxed))]})
    return ids


def _claro_sets(root: Path, name: str):
    return ["data.image_size=64", f"data.data_dir={root / 'raw'}",
            f"data.interim_dir={root / 'interim'}", f"data.box_file={root / 'boxes.xlsx'}",
            *(f"data.{k}_dir={root / name / k}" for k in ("reports", "model"))]


def test_manifest_readers_match_jax(tmp_path):
    _write_claro(tmp_path)
    info = tmp_path / "interim" / DATASET / f"patients_info_{DATASET}.xlsx"
    assert medical.read_patients_info(info) == jmed.read_patients_info(info)
    boxes = tmp_path / "boxes.xlsx"
    assert medical.read_box_manifest(boxes, "max_box") == jmed.read_box_manifest(boxes, "max_box")


def test_claro_preprocess_through_both_clis(tmp_path):
    """The stage from the manifests: the sorted intersection (the last
    slice has no box), the stack within 5e-6, each package's TIFFs read by
    the other's reader equal to its stack; --limit cuts the slices."""
    ids = _write_claro(tmp_path)
    runs = {}
    for name, main, extra in (("jax", jax_cli_main, ()), ("port", cli_main, ("--device", "cpu"))):
        assert main(["claro-preprocess", "--cfg", CFG, *extra, "--set",
                     *_claro_sets(tmp_path, name)]) == 0
        runs[name] = tmp_path / "interim" / DATASET / "00001--claro_preprocess"
        stack = np.load(runs[name] / "claro_preprocessed.npz")["images"]
        tifs = sorted((runs[name] / "stylegan").glob("*.tif"))
        assert [p.stem for p in tifs] == sorted(ids[:-1])
        read = tiff.read_tiff if name == "jax" else (lambda p: np.asarray(Image.open(p)))
        np.testing.assert_array_equal(np.stack([read(p) for p in tifs])[:, None], stack)
        runs[name] = stack
        # the next package's run gets run id 1 in a fresh interim root
        (tmp_path / "interim" / DATASET / "00001--claro_preprocess").rename(
            tmp_path / f"{name}_run")
    assert runs["port"].shape == (5, 1, 64, 64) and runs["port"].dtype == np.float32
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=0, atol=5e-6)
    assert cli_main(["claro-preprocess", "--cfg", CFG, "--device", "cpu", "--limit", "2",
                     "--set", *_claro_sets(tmp_path, "limit")]) == 0
    limited = tmp_path / "interim" / DATASET / "00001--claro_preprocess"
    assert np.load(limited / "claro_preprocessed.npz")["images"].shape == (2, 1, 64, 64)


@pytest.mark.parametrize("case", ["no_overlap", "no_box_file_zero_limit"])
def test_claro_preprocess_zero_match_diagnostics_match_jax(tmp_path, case):
    from gan_discovery_pso_tpu.core import load_config as jax_load_config
    from gan_discovery_pso_tpu.pipelines import StageContext as JStageContext
    from gan_discovery_pso_tpu.pipelines.analysis_stages import (
        run_claro_preprocess as jax_run_claro,
    )
    from gan_discovery_pso_tpu_torch.core import load_config
    from gan_discovery_pso_tpu_torch.pipelines import StageContext, run_claro_preprocess

    _write_claro(tmp_path, n_slices=1, boxed=["ZZZ_9"] if case == "no_overlap" else None)
    sets = dict(s.split("=", 1) for s in _claro_sets(tmp_path, "x"))
    limit = None
    if case != "no_overlap":
        sets["data.box_file"] = None
        limit = 0
    messages = []
    for make, create, run, kw in (
            (jax_load_config, JStageContext.create, jax_run_claro, {}),
            (load_config, StageContext.create, run_claro_preprocess, {"device": "cpu"})):
        ctx = create(make(CFG, overrides=sets), "claro_preprocess", **kw)
        with pytest.raises(ValueError, match="matched 0 slices") as err:
            run(ctx, limit=limit)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# -- augmentation ----------------------------------------------------------------------


def _jax_draws(key, n, h, w, cfg):
    """The raw draws `augment_image` makes from each image's key
    (augment.py:92-119), recomputed from the same splits."""
    rows = []
    for k in jax.random.split(key, n):
        ks = jax.random.split(k, 12)
        uni = (lambda kk, lo, hi: np.float32(jax.random.uniform(kk, (), minval=lo, maxval=hi)))
        rows.append((np.asarray(jax.random.uniform(ks[0], (5,))),
                     uni(ks[1], -cfg.shift_perc * h, cfg.shift_perc * h),
                     uni(ks[2], -cfg.shift_perc * w, cfg.shift_perc * w),
                     uni(ks[3], -cfg.max_angle, cfg.max_angle),
                     uni(ks[4], 1 - cfg.zoom_perc, 1 + cfg.zoom_perc),
                     uni(ks[5], 0.0, 1.0), uni(ks[6], *cfg.elastic_alpha),
                     np.asarray(jax.random.uniform(ks[7], (h, w))),
                     np.asarray(jax.random.uniform(ks[8], (h, w)))))
    return augment.AugmentDraws(*(torch.tensor(np.stack(col)) for col in zip(*rows)))


@pytest.mark.parametrize("zoom,elastic,prob,seed", [(True, True, 0.5, 3), (False, False, 0.3, 4),
                                                    (True, False, 0.9, 5), (False, True, 1.0, 6)])
def test_augment_batch_matches_jax_on_its_draws(zoom, elastic, prob, seed):
    n, c, h, w = 6, 2, 64, 48
    imgs = np.random.RandomState(seed).rand(n, c, h, w).astype(np.float32)
    jcfg = jaug.AugmentConfig(prob=prob, zoom=zoom, elastic=elastic)
    cfg = augment.AugmentConfig(prob=prob, zoom=zoom, elastic=elastic)
    key = jax.random.key(seed)
    want = np.asarray(jaug.augment_batch(key, jnp.asarray(imgs), jcfg))
    got = augment.augment_batch(torch.from_numpy(imgs), cfg, _jax_draws(key, n, h, w, jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_draw_augment_ranges():
    cfg = augment.AugmentConfig(zoom=True, elastic=True)
    d = augment.draw_augment(256, 8, 6, cfg, torch.Generator().manual_seed(0), device="cpu")
    assert d.u.shape == (256, 5) and d.field_y.shape == (256, 8, 6)
    assert float(d.dy.abs().max()) <= 0.8 and float(d.dx.abs().max()) <= 0.6
    assert float(d.angle.abs().max()) <= 175.0
    assert 0.9 <= float(d.zoom.min()) and float(d.zoom.max()) <= 1.1
    assert 20.0 <= float(d.alpha.min()) and float(d.alpha.max()) <= 40.0
    again = augment.draw_augment(256, 8, 6, cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    out = augment.augment_batch(torch.rand(256, 1, 8, 6), cfg, d)
    assert out.shape == (256, 1, 8, 6) and bool(torch.isfinite(out).all())


def test_claro_preprocess_runs_without_sklearn_or_pil(tmp_path):
    """The card's host has neither: the stage reads and writes its TIFFs
    and manifests without them; a .png slice is refused, naming PIL."""
    _write_claro(tmp_path)
    (tmp_path / "x.png").write_bytes(b"")
    code = textwrap.dedent(f"""
        import sys
        for missing in ("sklearn", "PIL", "matplotlib"):
            sys.modules[missing] = None
        from gan_discovery_pso_tpu_torch.cli.main import main
        from gan_discovery_pso_tpu_torch.data.medical import load_slice_image
        assert main(["claro-preprocess", "--cfg", {CFG!r}, "--device", "cpu", "--set",
                     *{_claro_sets(tmp_path, "nopil")!r}]) == 0
        try:
            load_slice_image({str(tmp_path / "x.png")!r})
        except RuntimeError as e:
            print("refused:", e)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "refused:" in proc.stdout and "needs PIL" in proc.stdout
    run = tmp_path / "interim" / DATASET / "00001--claro_preprocess"
    assert np.load(run / "claro_preprocessed.npz")["images"].shape == (5, 1, 64, 64)
    assert importlib.util.find_spec("PIL") is not None  # this host has it; the child had not
