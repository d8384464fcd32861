"""The port's query-block quantization (`kronfluence_tpu_torch/ops/quantize.py`)
against `kronfluence_tpu/ops/quantize.py`: bit-identical payloads and equal
scales for every storage format, and the same merge and dequantization."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kronfluence_tpu.ops.quantize import concat_quantized as jax_concat_quantized
from kronfluence_tpu.ops.quantize import dequantize_gradient as jax_dequantize_gradient
from kronfluence_tpu.ops.quantize import quantize_gradient as jax_quantize_gradient
from kronfluence_tpu_torch.ops.quantize import (
    QuantizedGradient,
    concat_quantized,
    dequantize_gradient,
    quantize_gradient,
)

FORMATS = ["float8_e4m3fn", "float8_e5m2", "bfloat16", "float16"]
_BITS = {1: np.uint8, 2: np.uint16}


def _block(seed: int, dtype=np.float32) -> np.ndarray:
    """(6, 8, 16) queries: ordinary gradients, one zero query, one huge, one
    tiny (for fp8 its scale floors at fp32's min normal; its values stay
    normal, since XLA's CPU backend flushes subnormals to zero), one with many
    entries tied at its max-abs (they land on the clip bound), one
    sign-alternating."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((6, 8, 16)).astype(np.float32) * 1e-3
    g[1] = 0.0
    g[2] *= 1e33
    g[3] = np.sign(g[3]) * (0.02 + rng.uniform(size=(8, 16)).astype(np.float32)) * 5e-36
    g[4, :4] = np.abs(g[4]).max()
    g[4, 4:6] = -np.abs(g[4]).max()
    g[5] = np.where(np.arange(16) % 2, 1.0, -1.0).astype(np.float32) * 7.0
    return g.astype(dtype)


def _payload_bits(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        width = data.element_size()
        return data.view({1: torch.uint8, 2: torch.int16}[width]).numpy().view(_BITS[width])
    data = np.asarray(data)
    return data.view(_BITS[data.dtype.itemsize])


@pytest.mark.parametrize("input_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_payload_bit_identical_and_scales_equal(fmt, input_dtype):
    host = _block(0)
    if input_dtype == "bfloat16":
        jin = jnp.asarray(host).astype(jnp.bfloat16)
        tin = torch.from_numpy(host).to(torch.bfloat16)
    else:
        jin, tin = jnp.asarray(host), torch.from_numpy(host)
    want = jax_quantize_gradient(jin, getattr(jnp, fmt))
    got = quantize_gradient(tin, fmt)
    assert got.data.dtype == getattr(torch, fmt) and got.scale.dtype == torch.float32
    assert got.shape == tuple(want.shape) and got.scale.shape == (6, 1, 1)
    np.testing.assert_array_equal(_payload_bits(got.data), _payload_bits(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[1].item() == 1.0 and not bool(got.data[1].float().any())
    assert bool(torch.isfinite(got.data.float()).all())


@pytest.mark.parametrize("fmt", FORMATS)
def test_concat_and_dequantize_match(fmt):
    blocks = [_block(seed) for seed in (1, 2, 3)]
    want = jax_concat_quantized([jax_quantize_gradient(jnp.asarray(b), getattr(jnp, fmt))
                                 for b in blocks])
    got = concat_quantized([quantize_gradient(torch.from_numpy(b), fmt) for b in blocks])
    assert got.shape == (18, 8, 16)
    np.testing.assert_array_equal(_payload_bits(got.data), _payload_bits(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    for dtype in ("float32", "float64"):
        np.testing.assert_array_equal(
            dequantize_gradient(got, dtype).numpy(),
            np.asarray(jax_dequantize_gradient(want, getattr(jnp, dtype))),
        )


def test_dequantize_passes_dense_blocks_through():
    dense = torch.ones(2, 3, 4)
    assert dequantize_gradient(dense, "float32") is dense
    q = QuantizedGradient(torch.ones(2, 3, 4).to(torch.float8_e4m3fn), torch.full((2, 1, 1), 0.5))
    assert torch.equal(q.dequantize(torch.float32), torch.full((2, 3, 4), 0.5))


def test_ml_dtypes_and_torch_agree_on_fp8_values():
    """The bit comparison above relies on both sides decoding the same bits
    to the same value."""
    bits = np.arange(256, dtype=np.uint8)
    for fmt in ("float8_e4m3fn", "float8_e5m2"):
        want = bits.view(getattr(ml_dtypes, fmt)).astype(np.float32)
        got = torch.from_numpy(bits).view(getattr(torch, fmt)).float().numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
