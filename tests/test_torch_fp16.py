"""fp16 in the port: autocast with loss scaling (`amp_dtype="float16"`,
`amp_scale`) against the fp32 run and against the JAX package's fp16 run
(after tests/test_misc_features.py's test_amp_float16_loss_scaling), and fp16
operands of K1: `gram` routes them as it routes bf16, and on the card the
kernel matches its plain version."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch import nn

from kronfluence_tpu.arguments import FactorArguments as JaxFactorArguments
from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu.task import Task as JaxTask
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch.arguments import FactorArguments
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.ops import covariance as covariance_ops
from kronfluence_tpu_torch.ops.kernels.syrk import bf16_route, syrk, syrk_reference
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader
from kronfluence_tpu_torch.utils.dtypes import accumulation_dtype

# The JAX package's fp16 limit (test_misc_features.py:344): relative to max|C|.
FP16_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


class _FlaxDense(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(3, name="fc", param_dtype=jnp.float32)(x)


class _JaxTask(JaxTask):
    def compute_train_loss(self, batch, model, sample=False, rng=None):
        return jnp.sum((model(batch["x"]) - batch["y"]) ** 2)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)


class _TorchDense(nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.fc = nn.Linear(4, 3)
        with torch.no_grad():
            self.fc.weight.copy_(torch.tensor(np.asarray(kernel).T))
            self.fc.bias.copy_(torch.tensor(np.asarray(bias)))

    def forward(self, x):
        # A torch module computes in its parameters' dtype (flax promotes
        # instead); under fp16 autocast the port casts the parameters.
        return self.fc(x.to(self.fc.weight.dtype))


class _TorchTask(Task):
    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return torch.sum((model(batch["x"]) - batch["y"]) ** 2)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(0)
    data = {
        "x": rng.standard_normal((16, 4)).astype(np.float32),
        "y": rng.standard_normal((16, 3)).astype(np.float32),
    }
    module = _FlaxDense()
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(data["x"][:1]))["params"]
    jtask, ttask = _JaxTask(), _TorchTask()
    tmodel = prepare_model(_TorchDense(params["fc"]["kernel"], params["fc"]["bias"]), ttask)
    return dict(data=data, params=params, jmodel=jax_prepare(module, jtask), jtask=jtask,
                tmodel=tmodel, ttask=ttask)


def _port(d, **fields):
    return fit_covariance_matrices_with_loader(
        d["tmodel"], d["ttask"], BatchLoader(d["data"], 8, device="cpu"),
        FactorArguments(use_empirical_fisher=True, **fields))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("factor", [ACTIVATION_COVARIANCE_MATRIX_NAME,
                                    GRADIENT_COVARIANCE_MATRIX_NAME])
def test_fp16_loss_scaling_matches_fp32_and_jax(dense, factor):
    base = _port(dense)
    amp = _port(dense, amp_dtype="float16", amp_scale=2.0 ** 10)
    jamp = jax_fit_covariance(
        dense["jmodel"], dense["params"], dense["jtask"], JaxBatchLoader(dense["data"], 8),
        JaxFactorArguments(use_empirical_fisher=True, amp_dtype="float16", amp_scale=2.0 ** 10))
    got = amp[factor]["fc"].numpy()
    assert np.isfinite(got).all()
    assert _rel(got, base[factor]["fc"].numpy()) < FP16_RTOL
    assert _rel(got, jamp[factor]["fc"]) < FP16_RTOL


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("n,through_k1", [(2048, True), (2304, True), (768, False)])
def test_gram_routes_fp16_like_bf16(monkeypatch, dtype, n, through_k1):
    """fp16 and bf16 accumulate in fp32, so both reach K1 at the JAX shape
    rule's widths (its plain version on the CPU) and give its fp32 product."""
    calls = []
    real = covariance_ops.syrk

    def recording(flat, accum_dtype=torch.float32):
        calls.append((flat.dtype, accum_dtype))
        return real(flat, accum_dtype)

    monkeypatch.setattr(covariance_ops, "syrk", recording)
    flat = torch.randn(64, n, generator=torch.Generator().manual_seed(0)).to(dtype)
    accum = accumulation_dtype(dtype)
    assert accum == torch.float32
    got = covariance_ops.gram(flat, accum)
    assert calls == ([(dtype, torch.float32)] if through_k1 else [])
    assert got.dtype == torch.float32
    assert torch.equal(got, syrk_reference(flat, torch.float32))


def test_fp16_operands_route_as_bf16():
    """The route rule is the 16-bit one for both types: TMA describes a row
    of whole 16-byte units."""
    for dtype in (torch.float16, torch.bfloat16):
        a = torch.zeros(4, 2304, dtype=dtype)
        assert bf16_route(2304, a.data_ptr()) == "wgmma"
        assert bf16_route(1001, a.data_ptr()) == "wmma"


def test_fp16_covariance_dtypes_on_the_cpu(dense):
    """fp16 covariance dtypes store fp16 factors summed in fp32."""
    base = _port(dense)
    half = _port(dense, activation_covariance_dtype="float16", gradient_covariance_dtype="float16")
    for factor in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        assert half[factor]["fc"].dtype == torch.float16
        assert _rel(half[factor]["fc"].float().numpy(), base[factor]["fc"].numpy()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(8192, 3072), (8192, 2304), (1000, 2000), (300, 1001)])
def test_cuda_syrk_on_fp16_operands(rows, n):
    """Card only: an fp16 operand takes the fp16 build of the kernel the
    route names (wgmma at n % 8 == 0, else wmma), counted as an fp16 launch;
    C is exactly symmetric and |kernel - plain| <= 1e-4 max|C| + 1e-4 |plain|
    against the plain version in fp32 (fp16 x fp16 products are exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randn(rows, n, generator=gen, device="cuda").to(torch.float16)
    wgmma = bf16_route(n, a.data_ptr()) == "wgmma"
    assert wgmma == (n % 8 == 0)
    before = (syrk.launches, syrk.wgmma_launches, syrk.f16_launches)
    got = syrk(a)
    want = syrk_reference(a, torch.float32)
    torch.cuda.synchronize()
    assert (syrk.launches, syrk.wgmma_launches, syrk.f16_launches) == (
        before[0] + 1, before[1] + wgmma, before[2] + 1)
    assert torch.equal(got, got.T)
    assert bool(((got - want).abs() <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all())
