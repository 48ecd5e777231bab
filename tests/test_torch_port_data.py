"""The port's data layer against the JAX package's on the CPU: the synthetic
digits, the idx reader (plain and gzip), the class filter and drange map,
the train/val split, epoch batches, and the stage context's dataset and
batches. Tiny idx files (120 images) stand in for MNIST; the synthetic
fallback is checked on the 4000-image test split."""

import gzip
import struct

import jax
import numpy as np
import pytest
import torch

from gan_discovery_pso_tpu.data import load_mnist as jax_load_mnist
from gan_discovery_pso_tpu.data import synth_digits as jax_synth_digits
from gan_discovery_pso_tpu.data import train_val_split as jax_train_val_split
from gan_discovery_pso_tpu.ops.rescale import adjust_dynamic_range as jax_adjust
from gan_discovery_pso_tpu_torch.core.prng import KeyChain
from gan_discovery_pso_tpu_torch.data import (
    ImageDataset,
    epoch_batches,
    load_mnist,
    synth_digits,
    train_val_split,
)
from gan_discovery_pso_tpu_torch.ops import adjust_dynamic_range
from gan_discovery_pso_tpu_torch.pipelines import StageContext

CFG = "configs/dcgan_mnist.yaml"
N_IMAGES = 120


def write_idx(root, n=N_IMAGES, seed=0, gz=False, split="train"):
    """Seeded idx files in the torchvision layout under root/MNIST/raw."""
    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = (np.arange(n) % 10).astype(np.uint8)
    rs.shuffle(labels)
    stem = "train" if split == "train" else "t10k"
    opener, suffix = (gzip.open, ".gz") if gz else (open, "")
    with opener(raw / f"{stem}-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
    with opener(raw / f"{stem}-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 0x801, n) + labels.tobytes())
    return images, labels


def test_synth_digits_is_bit_equal_to_jax():
    for n, seed in ((40, 0), (25, 3)):
        img, lab = synth_digits(n, seed=seed)
        want_img, want_lab = jax_synth_digits(n, seed=seed)
        assert img.dtype == want_img.dtype and img.tobytes() == want_img.tobytes()
        np.testing.assert_array_equal(lab, want_lab)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("drange", [(-1, 1), (0, 1)])
@pytest.mark.parametrize("classes", [None, (1, 5)])
def test_load_mnist_matches_jax_on_idx_files(tmp_path, gz, drange, classes):
    """Within 1 ulp: both map [0, 1] → drange with fp32 scale and bias."""
    write_idx(tmp_path, gz=gz)
    got = load_mnist(tmp_path, "train", classes=classes, drange=drange, device="cpu")
    want = jax_load_mnist(tmp_path, "train", classes=classes, drange=drange)
    assert got.source == want.source == "mnist-idx" and got.drange == want.drange
    assert got.images.dtype == torch.float32 and got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_max_ulp(got.images.numpy(), np.asarray(want.images), maxulp=1)
    lo, hi = drange
    assert float(got.images.min()) >= lo and float(got.images.max()) <= hi
    if classes is not None:
        assert set(np.unique(got.labels.numpy())) == set(classes)


def test_synthetic_fallback_matches_jax(tmp_path):
    got = load_mnist(tmp_path, "test", classes=(1,), drange=(-1, 1), device="cpu")
    want = jax_load_mnist(tmp_path, "test", classes=(1,), drange=(-1, 1))
    assert got.source == want.source == "synthetic"
    np.testing.assert_array_max_ulp(got.images.numpy(), np.asarray(want.images), maxulp=1)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    # the rendered arrays are shared across loads; a loaded tensor is a copy
    got.images.fill_(9.0)
    again = load_mnist(tmp_path, "test", classes=(1,), drange=(-1, 1), device="cpu")
    assert float(again.images.max()) <= 1.0


def test_non_native_image_size_raises_naming_a14(tmp_path):
    """A non-native image_size used to raise naming ROADMAP A14; A14 ported
    the resize (`ops/resize.py`), so it now loads, within 2e-6 of the
    range of JAX's `jax.image.resize(..., "bilinear")`, up and down."""
    write_idx(tmp_path)
    for size in (64, 32, 20):
        got = load_mnist(tmp_path, "train", image_size=size, device="cpu")
        want = jax_load_mnist(tmp_path, "train", image_size=size)
        assert tuple(got.images.shape) == tuple(want.images.shape) == (N_IMAGES, 1, size, size)
        np.testing.assert_allclose(got.images.numpy(), np.asarray(want.images), rtol=0,
                                   atol=2e-6 * 2)  # drange (-1, 1): a range of 2


@pytest.mark.parametrize("image_size", [28, 64], ids=["native", "resized"])
def test_load_mnist_without_device_raises_on_a_host_without_cuda(tmp_path, monkeypatch,
                                                                 image_size):
    """The images land on the card, and a resize runs there, unless the
    caller names a device; a host without CUDA raises rather than quietly
    keeping them on the CPU."""
    write_idx(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_mnist(tmp_path, "train", image_size=image_size)


@pytest.mark.parametrize("drange_in,drange_out", [((0, 1), (-1, 1)), ((0, 1), (0, 1)),
                                                  ((-1, 1), (0, 255)), ((0, 1), (-0.3, 0.7))])
def test_adjust_dynamic_range_matches_jax(drange_in, drange_out):
    x = np.random.RandomState(1).rand(64).astype(np.float32)
    want = np.asarray(jax_adjust(x, drange_in, drange_out))
    for got in (adjust_dynamic_range(x, drange_in, drange_out),
                adjust_dynamic_range(torch.tensor(x), drange_in, drange_out).numpy()):
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("fraction", [0.2, 0.25])
def test_train_val_split_matches_jax(tmp_path, fraction):
    """The last `fraction` of the images, unshuffled."""
    write_idx(tmp_path)
    tr, va = train_val_split(load_mnist(tmp_path, "train", device="cpu"), fraction)
    jtr, jva = jax_train_val_split(jax_load_mnist(tmp_path, "train"), fraction)
    for got, want in ((tr, jtr), (va, jva)):
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_array_max_ulp(got.images.numpy(), np.asarray(want.images), maxulp=1)
    assert va.images.shape[0] == int(N_IMAGES * fraction)


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_batches_cover_every_index(drop_last):
    n, bs = 23, 5
    ds = ImageDataset(torch.arange(n, dtype=torch.float32).reshape(n, 1, 1, 1),
                      torch.arange(n, dtype=torch.int32), (0, 1), "test")
    g = torch.Generator().manual_seed(3)
    batches = list(epoch_batches(ds, bs, g, drop_last=drop_last))
    sizes = [len(y) for _, y in batches]
    assert sizes == ([bs] * (n // bs) + ([] if drop_last else [n % bs]))
    seen = torch.cat([y for _, y in batches])
    for x, y in batches:  # images and labels stay paired
        assert torch.equal(x.reshape(-1).to(torch.int32), y)
    if drop_last:
        assert len(set(seen.tolist())) == len(seen) == n - n % bs
    else:
        assert sorted(seen.tolist()) == list(range(n))
    again = list(epoch_batches(ds, bs, torch.Generator().manual_seed(3), drop_last=drop_last))
    assert torch.equal(torch.cat([y for _, y in again]), seen)
    assert seen.tolist() != list(range(len(seen)))  # shuffled


def test_key_chain_peek_does_not_advance():
    keys = KeyChain(7)
    a = torch.rand(4, generator=keys.peek("epoch_0"))
    b = torch.rand(4, generator=keys.peek("epoch_0"))
    c = torch.rand(4, generator=keys("epoch_0"))
    d = torch.rand(4, generator=keys("epoch_0"))
    assert torch.equal(a, b) and torch.equal(a, c) and not torch.equal(c, d)


def _ctx(tmp_path, name, **overrides):
    return StageContext.create(CFG, name, device="cpu", overrides={
        "data.data_dir": str(tmp_path / "data"),
        **{f"data.{k}_dir": str(tmp_path / name / k) for k in ("reports", "model", "interim")},
        **overrides})


def test_stage_context_dataset_limit_and_digit_grid(tmp_path):
    write_idx(tmp_path / "data")
    ctx = _ctx(tmp_path, "ctx")
    ds = ctx.dataset()  # the IiD classes in drange_net
    want = jax_load_mnist(tmp_path / "data", "train", classes=ctx.data_cfg.iid_classes,
                          drange=ctx.data_cfg.drange_net)
    np.testing.assert_array_equal(ds.labels.numpy(), np.asarray(want.labels))
    assert ds.images.device == ctx.device
    assert (ctx.run.general_dir / "mnist.png").exists()
    ctx.limit = 10
    small = ctx.dataset("train", classes=(1,), drange=(0, 1))
    assert small.images.shape == (10, 1, 28, 28) and set(small.labels.tolist()) == {1}
    assert float(small.images.min()) >= 0.0


def test_stage_context_batches_are_fixed_per_epoch(tmp_path):
    write_idx(tmp_path / "data")
    ctx = _ctx(tmp_path, "batches")
    ds = ctx.dataset("train", classes=range(10), drange=(0, 1))
    make = ctx.batches(ds, 16)
    first = [y for _, y in make(0)]
    assert all(torch.equal(a, b) for a, b in zip(first, [y for _, y in make(0)]))
    assert len(first) == N_IMAGES // 16
    assert not torch.equal(torch.cat(first), torch.cat([y for _, y in make(1)]))
    val = list(ctx.batches(ds, 16, drop_last=False)(0))
    assert sum(len(y) for _, y in val) == N_IMAGES
