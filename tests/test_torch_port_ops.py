"""The PyTorch port's ops against the JAX package's, on the shapes of
tests/test_ops_parity.py. Inputs come from numpy seeds and go to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gan_discovery_pso_tpu import ops as jops
from gan_discovery_pso_tpu_torch import ops as tops

RTOL, ATOL = 1e-5, 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("cin,cout,k,s,p,hw", [
    (1, 64, 4, 2, 1, 28),
    (128, 1, 7, 2, 0, 7),
    (3, 64, 7, 2, 3, 64),
    (8, 16, 3, 2, 1, 14),
    (16, 32, 3, 2, 0, 7),
])
def test_conv2d_matches_jax(cin, cout, k, s, p, hw):
    x = _rand(2, cin, hw, hw, seed=1)
    w = _rand(cout, cin, k, k, seed=2) * 0.1
    b = _rand(cout, seed=3) * 0.1
    want = np.asarray(jops.conv2d(jnp.array(x), jnp.array(w), jnp.array(b), stride=s, padding=p))
    got = tops.conv2d(_t(x), _t(w), _t(b), stride=s, padding=p).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cin,cout,k,s,p,op,hw", [
    (100, 128, 7, 1, 0, 0, 1),
    (128, 64, 4, 2, 1, 0, 7),
    (64, 1, 4, 2, 1, 0, 14),
    (32, 16, 3, 2, 0, 0, 3),
    (16, 8, 3, 2, 1, 1, 7),
    (8, 1, 3, 2, 1, 1, 14),
])
def test_conv_transpose2d_matches_jax(cin, cout, k, s, p, op, hw):
    x = _rand(2, cin, hw, hw, seed=4)
    w = _rand(cin, cout, k, k, seed=5) * 0.1
    b = _rand(cout, seed=6) * 0.1
    want = np.asarray(jops.conv_transpose2d(jnp.array(x), jnp.array(w), jnp.array(b),
                                            stride=s, padding=p, output_padding=op))
    got = tops.conv_transpose2d(_t(x), _t(w), _t(b), stride=s, padding=p,
                                output_padding=op).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_conv_bf16_weights_return_fp32_like_jax_fast_math():
    """bf16 weights: the product runs in bf16, the result comes back fp32
    with the bias added in fp32 (the JAX package's preferred_element_type)."""
    x = _rand(2, 16, 7, 7, seed=7)
    w = _rand(16, 8, 4, 4, seed=8) * 0.1
    b = _rand(8, seed=9) * 0.1
    got = tops.conv_transpose2d(_t(x), _t(w).bfloat16(), _t(b).bfloat16(), stride=2, padding=1)
    assert got.dtype == torch.float32
    want = np.asarray(jops.conv_transpose2d(
        jnp.array(x), jnp.array(w, jnp.bfloat16), jnp.array(b, jnp.bfloat16),
        stride=2, padding=1))
    # the port rounds the conv sum to bf16 before the fp32 bias add
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)


def test_batch_norm_eval_matches_jax():
    x = _rand(4, 8, 5, 5, seed=10)
    scale = _rand(8, seed=11) * 0.1 + 1.0
    bias = _rand(8, seed=12) * 0.1
    rm = _rand(8, seed=13) * 0.2
    rv = np.abs(_rand(8, seed=14)) + 0.5
    want = np.asarray(jops.batch_norm_eval(
        jnp.array(x), jnp.array(scale), jnp.array(bias),
        jops.BatchNormStats(jnp.array(rm), jnp.array(rv))))
    got = tops.batch_norm_eval(_t(x), _t(scale), _t(bias), _t(rm), _t(rv)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,s,p,hw", [
    (3, 2, 1, 14), (2, 2, 0, 28), (3, 2, 1, 7), (2, 2, 0, 7), (3, 3, 0, 14),
])
def test_max_pool2d_matches_jax(k, s, p, hw):
    x = _rand(2, 4, hw, hw, seed=15)
    want = np.asarray(jops.max_pool2d(jnp.array(x), k, s, p))
    got = tops.max_pool2d(_t(x), k, s, p).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_adaptive_max_pool2d_matches_jax():
    x = _rand(2, 6, 7, 7, seed=16)
    want = np.asarray(jops.adaptive_max_pool2d(jnp.array(x), (1, 1)))
    np.testing.assert_array_equal(tops.adaptive_max_pool2d(_t(x), (1, 1)).numpy(), want)


def test_rescale01_per_sample_bit_equal_to_jax():
    imgs = _rand(5, 1, 28, 28, seed=17) * 3.0 + 1.0
    imgs[2] = 0.25  # a constant image: 0/0 → NaN on both sides
    want = np.asarray(jops.rescale01_per_sample(jnp.array(imgs)))
    got = tops.rescale01_per_sample(_t(imgs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]).all()
    assert np.nanmin(got) >= 0.0 and np.nanmax(got) <= 1.0


def test_fp32_parity_sets_and_restores_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    with tops.fp32_parity():
        assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.deterministic and not cudnn.benchmark
    assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark) == before


def test_cast_model_copies_in_dtype():
    m = torch.nn.Sequential(torch.nn.Conv2d(1, 2, 3), torch.nn.BatchNorm2d(2))
    assert tops.cast_model(m, None) is m
    m16 = tops.cast_model(m, torch.bfloat16)
    assert m16 is not m and m[0].weight.dtype == torch.float32
    assert m16[0].weight.dtype == torch.bfloat16
    assert m16[1].running_var.dtype == torch.bfloat16
