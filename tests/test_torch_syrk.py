"""K1 (syrk) and K3 (probe) of kronfluence_tpu_torch against the JAX package.

On the CPU the port's wrappers take their plain versions, so these tests hold
the plain versions against the JAX Pallas kernel (interpret mode) and check
the dispatch rules. The CUDA kernels themselves are compared with the plain
versions on the card by chip_smoke.py and by the `cuda`-marked tests below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kronfluence_tpu.ops.pallas.syrk import syrk as jax_syrk
from kronfluence_tpu.ops.pallas.syrk import syrk_supported as jax_syrk_supported
from kronfluence_tpu_torch.ops.covariance import bordered_gram, gram
from kronfluence_tpu_torch.ops.kernels.probe import PROBE_SHAPE, probe, probe_reference
from kronfluence_tpu_torch.ops.kernels.syrk import syrk, syrk_reference, syrk_supported


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n", [(300, 700), (640, 1100), (77, 513), (500, 640)])
def test_syrk_reference_matches_jax_kernel(rows, n, dtype):
    """The plain version against the interpret-mode Pallas kernel on the JAX
    package's own syrk test shapes, fp32 accumulation. fp32 operands: fp32
    summation-order noise (5e-6 of max|C|, the JAX package's bound for this
    kernel). bf16 operands: products of bf16 values are exact in fp32, so
    again only the summation order differs."""
    a = np.random.default_rng(rows + n).standard_normal((rows, n)).astype(np.float32)
    ja = jnp.asarray(a, jnp.dtype(dtype))
    want = np.asarray(jax_syrk(ja, jnp.float32, tile_n=256, tile_k=256, interpret=True))
    ta = torch.tensor(np.asarray(ja.astype(jnp.float32))).to(getattr(torch, dtype))
    got = syrk_reference(ta, torch.float32)
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=5e-6)


@pytest.mark.parametrize(
    "n,accum",
    [
        (2048, "float32"), (3073, "float32"), (769, "float32"), (2048, "float64"),
        (768, "float32"), (2304, "float32"), (3072, "float32"), (1536, "float32"),
        (1537, "float32"), (2304, "bfloat16"),
    ],
)
def test_syrk_supported_agrees_with_jax(n, accum):
    assert syrk_supported(n, accum) == jax_syrk_supported(n, jnp.dtype(accum))


def test_gpt2_widths_route_as_in_jax():
    """The main path's gram widths: 2304 and 3072 go to K1, 768 and 769 do not."""
    assert syrk_supported(2304, torch.float32)
    assert syrk_supported(3072, torch.float32)
    assert not syrk_supported(768, torch.float32)
    assert not syrk_supported(769, torch.float32)


def test_cpu_tensor_takes_plain_path_and_counts_nothing():
    before = syrk.launches
    a = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 2048)).astype(np.float32))
    got = syrk(a, torch.float32)
    via_gram = gram(a, torch.float32)  # 2048 passes the shape rule
    assert syrk.launches == before
    want = a.double().T @ a.double()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-4, atol=1e-3)
    assert torch.equal(via_gram, got)


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        syrk(torch.empty((16, 2048), device="meta"), torch.float32)


def test_bordered_gram_equals_gram_of_bias_augmented_operand():
    """The analytic bias border equals gram([A | mask]) (float64, exact)."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((40, 7)))
    mask = torch.from_numpy((rng.random((40, 1)) > 0.3).astype(np.float64))
    a2 = a * mask
    got = bordered_gram(a2, mask.sum().to(torch.int64), True, torch.float64)
    aug = torch.cat([a2, mask], dim=1)
    torch.testing.assert_close(got, aug.T @ aug, rtol=1e-12, atol=1e-12)


def test_probe_plain_version():
    src = torch.zeros(PROBE_SHAPE, dtype=torch.float32)
    assert torch.equal(probe_reference(src), torch.ones(PROBE_SHAPE))
    before = probe.launches
    assert torch.equal(probe("cpu"), torch.ones(PROBE_SHAPE))
    assert probe.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,n", [(8192, 3072), (1000, 2000), (300, 1001)])
def test_cuda_syrk_matches_plain_version(rows, n, dtype):
    """Card only: exact symmetry, and |kernel - plain| <= 1e-4 max|C| +
    1e-4 |plain| (fp32 sums of exact products in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    before = syrk.launches
    got = syrk(a)
    want = syrk_reference(a)
    torch.cuda.synchronize()
    assert syrk.launches == before + 1
    assert torch.equal(got, got.T)
    assert bool(((got - want).abs() <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all())


@pytest.mark.cuda
def test_cuda_probe_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    before = probe.launches
    assert torch.equal(probe("cuda").cpu(), torch.ones(PROBE_SHAPE))
    assert probe.launches == before + 1
