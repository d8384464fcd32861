"""The port's conv rules (ops/flatten.py, ops/covariance.py, the conv spec of
capture/context.py and models/cnn.py:Conv2d) against kronfluence_tpu on the
CPU: the cases of tests/test_conv.py, on NCHW inputs made from a numpy seed.
The port takes every conv layer's activation gram from its im2col patches;
the JAX package takes a patch-free symmetric-block form from 128 channels,
and the two are held equal.

Patch values are copies and must be equal, token rows equal to 1e-15; grams
are held to 2e-6 of their max (fp32, as the JAX test holds them) or 1e-12
(fp64)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch import nn

from kronfluence_tpu.capture.flax_integration import _conv_spec as jax_conv_spec
from kronfluence_tpu.capture.specs import LayerSpec as JaxLayerSpec
from kronfluence_tpu.ops import covariance as jcov
from kronfluence_tpu.ops import flatten as jflat
from kronfluence_tpu_torch.capture.context import conv_spec
from kronfluence_tpu_torch.capture.specs import LayerSpec
from kronfluence_tpu_torch.models.cnn import Conv2d
from kronfluence_tpu_torch.ops import covariance as tcov
from kronfluence_tpu_torch.ops import flatten as tflat
from kronfluence_tpu_torch.utils.exceptions import UnsupportableModuleError

GEOMETRIES = [
    ((1, 1), "SAME", (1, 1)),
    ((2, 2), "SAME", (1, 1)),
    ((2, 1), "VALID", (1, 1)),
    ((1, 1), ((2, 1), (0, 2)), (1, 1)),
    ((1, 1), "SAME", (2, 2)),
    ((2, 2), "VALID", (2, 3)),
]

# (strides, padding, dilation, use_bias, groups, masked), tests/test_conv.py:134-140.
CASES = [
    ((1, 1), "SAME", (1, 1), True, 1, False),
    ((1, 1), "SAME", (1, 1), True, 1, True),
    ((2, 1), "VALID", (1, 1), False, 1, True),
    ((1, 1), ((2, 1), (0, 2)), (1, 1), True, 2, False),
    ((2, 2), "VALID", (2, 3), True, 1, True),
    ((2, 2), "SAME", (1, 1), False, 3, True),
]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


def _specs(strides, padding, dilation, use_bias=True, groups=1, c_in=5, out=4):
    fields = dict(
        name="c", kind="conv2d", has_bias=use_bias, in_dim=(c_in // groups) * 9, out_dim=out,
        kernel_size=(3, 3), strides=strides, padding=padding, kernel_dilation=dilation,
        feature_group_count=groups,
    )
    return JaxLayerSpec(**fields), LayerSpec(**fields)


def _nhwc_and_nchw(shape, seed, dtype=np.float64):
    x = np.random.default_rng(seed).normal(size=shape).astype(dtype)
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("strides,padding,dilation", GEOMETRIES)
def test_patches_equal_jax(strides, padding, dilation):
    """im2col of the NCHW input equals the JAX package's of the NHWC input:
    the same rows (b, oh, ow) and channel-major features, bit for bit; and
    `F.unfold` orders its features the same way."""
    jx, tx = _nhwc_and_nchw((2, 9, 11, 5), seed=0)
    jspec, tspec = _specs(strides, padding, dilation)
    want = _np(jflat.extract_conv2d_patches(jx, jspec))
    got = _np(tflat.extract_conv2d_patches(tx, tspec))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    (top, bottom), (left, right) = tflat._resolve_conv_pads(tspec, 9, 11)
    if min(top, bottom, left, right) >= 0:
        unfold = torch.nn.functional.unfold(
            torch.nn.functional.pad(tx, (left, right, top, bottom)), (3, 3),
            dilation=dilation, stride=strides,
        )
        np.testing.assert_array_equal(_np(unfold.transpose(1, 2)), want)


@pytest.mark.parametrize("strides,padding,dilation,use_bias,groups,masked", CASES)
def test_token_rows_equal_jax(strides, padding, dilation, use_bias, groups, masked):
    """flatten_activation_parts, activation_tokens_with_bias, flatten_gradient
    and gradient_tokens on NCHW tensors equal the JAX rules on NHWC ones:
    values to 1e-15 (a group mean may round an ulp apart between XLA and
    torch; every other value is a copy), the counts (valid rows, no attention
    mask) equal."""
    c_in = 6 * groups
    jspec, tspec = _specs(strides, padding, dilation, use_bias, groups, c_in=c_in)
    jx, tx = _nhwc_and_nchw((4, 9, 11, c_in), seed=1)
    out_hw = tflat.conv2d_shift_windows(tx, tspec)[1][:2]
    jdy, tdy = _nhwc_and_nchw((4,) + out_hw + (4,), seed=2)
    valid = np.array([1, 1, 0, 1], np.float64) if masked else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)
    # A mask the size of the rows, half zeros: conv layers ignore it.
    mask = np.random.default_rng(7).integers(0, 2, size=(4, out_hw[0] * out_hw[1]))
    attention = jnp.asarray(mask), torch.from_numpy(mask)

    a_j, m_j, n_j = jflat.flatten_activation_parts(jspec, jx, attention[0], jvalid, jnp.float64)
    a_t, m_t, n_t = tflat.flatten_activation_parts(tspec, tx, attention[1], tvalid, torch.float64)
    _close(_np(a_t), _np(a_j))
    assert (m_t is None) == (m_j is None) and int(n_t) == int(n_j)
    _close(
        _np(tflat.activation_tokens_with_bias(tspec, tx, torch.float64)),
        _np(jflat.activation_tokens_with_bias(jspec, jx, jnp.float64)),
    )
    g_j, c_j = jflat.flatten_gradient(jspec, jdy, attention[0], jvalid, jnp.float64)
    g_t, c_t = tflat.flatten_gradient(tspec, tdy, attention[1], tvalid, torch.float64)
    _close(_np(g_t), _np(g_j))
    assert int(c_t) == int(c_j) == int(n_j)
    _close(
        _np(tflat.gradient_tokens(tspec, tdy, tvalid, torch.float64)),
        _np(jflat.gradient_tokens(jspec, jdy, jvalid, jnp.float64)),
    )


def test_gradient_rows_are_channels_last():
    """An NCHW output gradient becomes (b, oh, ow) rows of C_out features; a
    reshape of the NCHW tensor as it is would give other rows, of the
    same shape, without raising."""
    _, tspec = _specs((1, 1), "SAME", (1, 1), c_in=5, out=4)
    jdy, tdy = _nhwc_and_nchw((2, 3, 5, 4), seed=3)
    got = _np(tflat.gradient_tokens(tspec, tdy, None, torch.float64))
    np.testing.assert_array_equal(got, _np(jdy).reshape(2, 15, 4))
    assert not np.array_equal(got, _np(tdy).reshape(2, -1, 4))


def _jax_activation_gram(jspec, jx, valid, dtype):
    """The JAX covariance stage's activation gram of one conv use: its
    symmetric-block form where `use_conv_sym_gram` picks it, else the
    bordered im2col gram (kronfluence_tpu/factor/covariance.py:129-142)."""
    jdtype = jnp.dtype(dtype)
    jvalid = None if valid is None else jnp.asarray(valid)
    if jcov.use_conv_sym_gram(jspec):
        return jcov.conv_activation_gram(jspec, jx, jvalid, jdtype, jdtype)
    a2, _, count = jflat.flatten_activation_parts(jspec, jx, None, jvalid, jdtype)
    return jcov.bordered_gram(a2, count, jspec.has_bias, jdtype), count


def _port_activation_gram(tspec, tx, valid, dtype):
    """The port's covariance stage's activation gram of one conv use: the
    bordered gram of its im2col patches, at every width."""
    tdtype = getattr(torch, dtype)
    tvalid = None if valid is None else torch.from_numpy(valid)
    a2, _, count = tflat.flatten_activation_parts(tspec, tx, None, tvalid, tdtype)
    return tcov.bordered_gram(a2, count, tspec.has_bias, tdtype), count


def _assert_grams_equal(got, want, dtype):
    (g_t, n_t), (g_j, n_j) = got, want
    assert g_t.shape == g_j.shape and g_t.dtype == getattr(torch, dtype)
    assert int(n_t) == int(n_j)
    tol = 2e-6 if dtype == "float32" else 1e-12
    scale = float(np.abs(_np(g_j)).max())
    np.testing.assert_allclose(_np(g_t) / scale, _np(g_j) / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("strides,padding,dilation,use_bias,groups,masked", CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_im2col_gram_matches_jax_symmetric_gram(strides, padding, dilation, use_bias, groups,
                                                masked, dtype):
    """The port's bordered im2col gram equals the JAX package's patch-free
    `conv_activation_gram` of the same input, with the same count, over
    strides, padding, dilation, groups, bias and the valid mask."""
    c_in = 6 * groups
    jspec, tspec = _specs(strides, padding, dilation, use_bias, groups, c_in=c_in)
    jx, tx = _nhwc_and_nchw((4, 9, 11, c_in), seed=4, dtype=np.dtype(dtype))
    valid = np.array([1, 1, 0, 1], dtype) if masked else None
    jdtype = jnp.dtype(dtype)
    want = jcov.conv_activation_gram(
        jspec, jx, None if valid is None else jnp.asarray(valid), jdtype, jdtype)
    _assert_grams_equal(_port_activation_gram(tspec, tx, valid, dtype), want, dtype)


@pytest.mark.parametrize("c,k,sym", [(128, 3, True), (130, 3, True), (64, 3, False),
                                     (128, 1, False), (127, 3, False), (128, 2, True)])
def test_conv_gram_matches_jax_stage_at_its_threshold(c, k, sym):
    """On both sides of the JAX package's symmetric-block threshold (128
    channels, kernel wider than 1x1), the port's im2col gram equals the
    gram the JAX covariance stage takes there, in fp64 to 1e-12 of max."""
    fields = dict(name="c", kind="conv2d", has_bias=True, in_dim=c * k * k, out_dim=4,
                  kernel_size=(k, k), strides=(1, 1), padding="SAME",
                  kernel_dilation=(1, 1), feature_group_count=1)
    jspec, tspec = JaxLayerSpec(**fields), LayerSpec(**fields)
    assert jcov.use_conv_sym_gram(jspec) is sym
    jx, tx = _nhwc_and_nchw((2, 5, 4, c), seed=8)
    valid = np.array([1, 0], np.float64)
    _assert_grams_equal(_port_activation_gram(tspec, tx, valid, "float64"),
                        _jax_activation_gram(jspec, jx, valid, "float64"), "float64")


@pytest.mark.parametrize("strides,padding,dilation", GEOMETRIES)
@pytest.mark.parametrize("groups", [1, 2])
def test_conv2d_forward_and_spec_match_flax(strides, padding, dilation, groups):
    """models/cnn.py:Conv2d computes flax's nn.Conv on the converted kernel
    (HWIO to OIHW) at every geometry, stride-2 "SAME" included, and its
    capture spec equals the JAX package's for the flax module."""
    jx, tx = _nhwc_and_nchw((2, 9, 11, 4), seed=5)
    flax_conv = fnn.Conv(6, (3, 3), strides=strides, padding=padding,
                         kernel_dilation=dilation, feature_group_count=groups,
                         param_dtype=jnp.float64, dtype=jnp.float64)
    params = flax_conv.init(jax.random.PRNGKey(0), jx)["params"]
    want = _np(flax_conv.apply({"params": params}, jx)).transpose(0, 3, 1, 2)
    conv = Conv2d(4, 6, 3, stride=strides, padding=padding, dilation=dilation, groups=groups,
                  dtype=torch.float64)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(params["kernel"]).transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(np.array(params["bias"])))
        got = conv(tx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    want_spec = dataclasses.asdict(jax_conv_spec(flax_conv.bind({"params": params}), jx))
    assert conv_spec("c", conv) == LayerSpec(**{**want_spec, "name": "c"})


@pytest.mark.parametrize("padding,want", [
    (1, ((1, 1), (1, 1))), ((2, 0), ((2, 2), (0, 0))), ("same", "SAME"), ("valid", "VALID"),
])
def test_torch_conv_padding_spec(padding, want):
    """A plain nn.Conv2d's padding maps to the JAX package's form, and its
    'same' (even kernel included) pads as "SAME" does: the patches of the
    spec reproduce the module's output."""
    conv = nn.Conv2d(3, 2, (2, 3), padding=padding, bias=False, dtype=torch.float64)
    spec = conv_spec("c", conv)
    assert spec.padding == want and spec.in_dim == 18 and spec.kind == "conv2d"
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 3, 7, 6)))
    with torch.no_grad():
        y = conv(x)
    patches = tflat.extract_conv2d_patches(x, spec)
    got = patches @ conv.weight.reshape(2, -1).T  # (b, oh*ow, out)
    np.testing.assert_allclose(
        _np(got), _np(y.permute(0, 2, 3, 1).reshape(2, -1, 2)), rtol=1e-12, atol=1e-12
    )


def test_padding_mode_other_than_zeros_raises():
    with pytest.raises(UnsupportableModuleError, match="padding_mode"):
        conv_spec("c", nn.Conv2d(3, 2, 3, padding=1, padding_mode="reflect"))
