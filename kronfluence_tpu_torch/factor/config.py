"""Hessian-approximation strategies: identity / diagonal / kfac / ekfac.

Port of `kronfluence_tpu/factor/config.py`:

  * a per-strategy requirements matrix drives which artifacts each stage needs;
  * `prepare` damps and inverts once per module. It runs in float64, the
    reference's LAMBDA_DTYPE: the H100 has native fp64, so unlike the TPU
    build there is no float32 branch. The inverse lambda is then cast to the
    precondition dtype;
  * `precondition` applies `Q_g ((Q_g^T G Q_a) ∘ Λ^-1) Q_a^T`.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Type

import torch

from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_EIGENVALUES_NAME,
    ACTIVATION_EIGENVECTORS_NAME,
    GRADIENT_EIGENVALUES_NAME,
    GRADIENT_EIGENVECTORS_NAME,
    HEURISTIC_DAMPING_SCALE,
    LAMBDA_MATRIX_NAME,
    NUM_LAMBDA_PROCESSED,
)
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

_STRATEGIES: Dict[str, Type["FactorConfig"]] = {}
_WIDE = torch.float64


@dataclass
class PreconditionState:
    """Per-module preconditioning state, on the factors' device."""

    inverse_lambda: Optional[torch.Tensor] = None  # (out_dim, in_dim[+1])
    activation_eigenvectors: Optional[torch.Tensor] = None  # (in_dim[+1], in_dim[+1])
    gradient_eigenvectors: Optional[torch.Tensor] = None  # (out_dim, out_dim)


class FactorConfig:
    """Base strategy; subclasses self-register by name."""

    strategy: str = ""

    requires_covariance_matrices: bool = False
    requires_eigendecomposition: bool = False
    requires_eigendecomposition_for_lambda: bool = False
    requires_lambda_matrices: bool = False
    requires_covariance_matrices_for_precondition: bool = False
    requires_eigendecomposition_for_precondition: bool = False
    requires_lambda_matrices_for_precondition: bool = False

    #: Factor-dict keys `prepare()` reads, validated up front.
    required_precondition_factors: tuple = ()

    def __init_subclass__(cls, strategy: Optional[str] = None, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        if strategy is not None:
            cls.strategy = strategy
            _STRATEGIES[strategy] = cls

    def prepare(
        self,
        factors: Dict[str, torch.Tensor],
        damping_factor: Optional[float],
        precondition_dtype,
    ) -> PreconditionState:
        """One-time preparation of per-module precondition state."""
        raise NotImplementedError

    def precondition(self, gradient: torch.Tensor, state: PreconditionState) -> torch.Tensor:
        """Preconditions (batch, out_dim, in_dim[+1]) gradients."""
        raise NotImplementedError

    @staticmethod
    def _damp_and_invert(lambda_matrix: torch.Tensor, damping_factor: Optional[float]) -> torch.Tensor:
        """Damped reciprocal in float64; `damping_factor=None` is the
        heuristic 0.1 x mean eigenvalue."""
        lam = lambda_matrix.to(_WIDE)
        damping = HEURISTIC_DAMPING_SCALE * lam.mean() if damping_factor is None else damping_factor
        return torch.reciprocal(lam + damping)

    @staticmethod
    def _as_count(value: torch.Tensor) -> torch.Tensor:
        return value.reshape(()).to(_WIDE)


class Identity(FactorConfig, strategy="identity"):
    """No preconditioning: H ≈ I."""

    def prepare(self, factors, damping_factor, precondition_dtype) -> PreconditionState:
        del factors, damping_factor, precondition_dtype
        return PreconditionState()

    def precondition(self, gradient: torch.Tensor, state: PreconditionState) -> torch.Tensor:
        del state
        return gradient


class Diagonal(FactorConfig, strategy="diagonal"):
    """Diagonal Fisher: elementwise inverse of mean squared per-sample grads."""

    requires_lambda_matrices = True
    requires_lambda_matrices_for_precondition = True
    required_precondition_factors = (NUM_LAMBDA_PROCESSED, LAMBDA_MATRIX_NAME)

    def prepare(self, factors, damping_factor, precondition_dtype) -> PreconditionState:
        dtype = resolve_dtype(precondition_dtype)
        count = self._as_count(factors[NUM_LAMBDA_PROCESSED])
        lam = factors[LAMBDA_MATRIX_NAME].to(_WIDE) / count
        inv = self._damp_and_invert(lam, damping_factor)
        return PreconditionState(inverse_lambda=inv.to(dtype))

    def precondition(self, gradient: torch.Tensor, state: PreconditionState) -> torch.Tensor:
        return gradient * state.inverse_lambda.to(gradient.dtype)


class _EigenbasisSandwich(FactorConfig):
    """Shared math for KFAC/EKFAC: Q_g ((Q_g^T G Q_a) ∘ Λ^-1) Q_a^T."""

    def precondition(self, gradient: torch.Tensor, state: PreconditionState) -> torch.Tensor:
        q_a = state.activation_eigenvectors.to(gradient.dtype)
        q_g = state.gradient_eigenvectors.to(gradient.dtype)
        inv_lambda = state.inverse_lambda.to(gradient.dtype)
        rotated = torch.matmul(torch.matmul(q_g.T, gradient), q_a) * inv_lambda
        return torch.matmul(torch.matmul(q_g, rotated), q_a.T)

    @staticmethod
    def _eigenvectors(factors, dtype) -> Dict[str, torch.Tensor]:
        return dict(
            activation_eigenvectors=factors[ACTIVATION_EIGENVECTORS_NAME].to(dtype),
            gradient_eigenvectors=factors[GRADIENT_EIGENVECTORS_NAME].to(dtype),
        )


class Kfac(_EigenbasisSandwich, strategy="kfac"):
    """K-FAC: Λ is the Kronecker outer product of the factor eigenvalues."""

    requires_covariance_matrices = True
    requires_eigendecomposition = True
    requires_eigendecomposition_for_precondition = True
    required_precondition_factors = (
        ACTIVATION_EIGENVALUES_NAME,
        GRADIENT_EIGENVALUES_NAME,
        ACTIVATION_EIGENVECTORS_NAME,
        GRADIENT_EIGENVECTORS_NAME,
    )

    def prepare(self, factors, damping_factor, precondition_dtype) -> PreconditionState:
        dtype = resolve_dtype(precondition_dtype)
        act_ev = factors[ACTIVATION_EIGENVALUES_NAME].to(_WIDE)
        grad_ev = factors[GRADIENT_EIGENVALUES_NAME].to(_WIDE)
        inv = self._damp_and_invert(torch.outer(grad_ev, act_ev), damping_factor)
        return PreconditionState(inverse_lambda=inv.to(dtype), **self._eigenvectors(factors, dtype))


class Ekfac(_EigenbasisSandwich, strategy="ekfac"):
    """EK-FAC: eigenvalues corrected by fitted per-sample-gradient second moments."""

    requires_covariance_matrices = True
    requires_eigendecomposition = True
    requires_eigendecomposition_for_lambda = True
    requires_lambda_matrices = True
    requires_eigendecomposition_for_precondition = True
    requires_lambda_matrices_for_precondition = True
    required_precondition_factors = (
        NUM_LAMBDA_PROCESSED,
        LAMBDA_MATRIX_NAME,
        ACTIVATION_EIGENVECTORS_NAME,
        GRADIENT_EIGENVECTORS_NAME,
    )

    def prepare(self, factors, damping_factor, precondition_dtype) -> PreconditionState:
        dtype = resolve_dtype(precondition_dtype)
        count = self._as_count(factors[NUM_LAMBDA_PROCESSED])
        lam = factors[LAMBDA_MATRIX_NAME].to(_WIDE) / count
        inv = self._damp_and_invert(lam, damping_factor)
        return PreconditionState(inverse_lambda=inv.to(dtype), **self._eigenvectors(factors, dtype))


def get_factor_config(strategy: str) -> FactorConfig:
    try:
        return _STRATEGIES[strategy]()
    except KeyError as exc:
        raise ValueError(
            f"Unknown strategy {strategy!r}; available: {sorted(_STRATEGIES)}."
        ) from exc
