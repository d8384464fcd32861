"""Argument dataclasses for factor and score computations.

Port of `kronfluence_tpu/arguments.py`: the same fields and defaults, so a
config or persisted-arguments JSON moves between the two packages unchanged.
dtype fields accept strings, numpy dtypes or torch dtypes and serialize to
canonical names.
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

from kronfluence_tpu_torch.utils.dtypes import canonical_dtype_name

# Storage formats `query_gradient_storage_dtype` accepts (the table of
# ops/quantize.py).
STORAGE_DTYPES = ("bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")


@dataclass
class Arguments:
    """Base class with JSON round-trip support."""

    def to_dict(self) -> Dict[str, Any]:
        config = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.name.endswith("dtype"):
                value = canonical_dtype_name(value)
            config[f.name] = value
        return config

    def to_str_dict(self) -> Dict[str, str]:
        return {name: str(value) for name, value in self.to_dict().items()}


@dataclass
class FactorArguments(Arguments):
    """Arguments for fitting influence factors."""

    # General configuration.
    strategy: str = "ekfac"
    use_empirical_fisher: bool = False
    amp_dtype: Optional[Any] = None
    amp_scale: float = 2.0**16  # Loss scale, active for float16 autocast only.
    # Accepted for config parity; shared modules are detected from use counts.
    has_shared_parameters: bool = False
    # Seed of the torch.Generator that draws sampled labels (true Fisher).
    seed: int = 0

    # Covariance-matrix configuration.
    covariance_max_examples: Optional[int] = 100_000
    covariance_data_partitions: int = 1
    covariance_module_partitions: int = 1
    activation_covariance_dtype: Any = "float32"
    gradient_covariance_dtype: Any = "float32"

    # Eigendecomposition configuration. float64 runs on the host (LAPACK);
    # float32 on a CUDA device runs the solver named here: "auto" and "qdwh"
    # run `torch.linalg.eigh` (cuSOLVER); "jacobi" runs the blocked-Jacobi
    # solver (ops/eigh.py, pivot solves in the K2 CUDA kernel) and raises at
    # dimensions >= 6144; "dc" is TPU-only and raises. Ignored by the host path.
    eigendecomposition_dtype: Any = "float64"
    eigendecomposition_solver: str = "auto"

    # Lambda-matrix configuration.
    lambda_max_examples: Optional[int] = 100_000
    lambda_data_partitions: int = 1
    lambda_module_partitions: int = 1
    use_iterative_lambda_aggregation: bool = False
    offload_activations_to_cpu: bool = False
    per_sample_gradient_dtype: Any = "float32"
    lambda_dtype: Any = "float32"

    def __post_init__(self) -> None:
        if self.strategy not in ("identity", "diagonal", "kfac", "ekfac"):
            raise ValueError(f"Unknown strategy: {self.strategy!r}.")
        if self.eigendecomposition_solver not in ("auto", "qdwh", "jacobi", "dc"):
            raise ValueError(
                "`eigendecomposition_solver` must be 'auto', 'qdwh', 'jacobi', or 'dc'."
            )
        for name in ("covariance_max_examples", "lambda_max_examples"):
            value = getattr(self, name)
            if value is not None and value <= 0:
                raise ValueError(f"`{name}` must be positive or None.")
        for name in (
            "covariance_data_partitions",
            "covariance_module_partitions",
            "lambda_data_partitions",
            "lambda_module_partitions",
        ):
            if getattr(self, name) <= 0:
                raise ValueError(f"`{name}` must be positive.")


@dataclass
class ScoreArguments(Arguments):
    """Arguments for computing influence scores."""

    # General configuration.
    damping_factor: Optional[float] = 1.0e-08
    amp_dtype: Optional[Any] = None
    offload_activations_to_cpu: bool = False

    # Partition configuration.
    data_partitions: int = 1
    module_partitions: int = 1

    # Score configuration.
    compute_per_module_scores: bool = False
    compute_per_token_scores: bool = False

    # Query-gradient batching configuration. `None` sizes the block from the
    # memory model (utils/memory.py:max_queries_per_block).
    query_gradient_accumulation_steps: Optional[int] = 1
    query_gradient_low_rank: Optional[int] = None
    use_full_svd: bool = False

    # Gradient-aggregation configuration.
    aggregate_query_gradients: bool = False
    aggregate_train_gradients: bool = False

    # Self-influence configuration.
    use_measurement_for_self_influence: bool = False

    # dtype configuration.
    query_gradient_svd_dtype: Any = "float32"
    per_sample_gradient_dtype: Any = "float32"
    precondition_dtype: Any = "float32"
    score_dtype: Any = "float32"
    # Storage dtype of the resident query block (see STORAGE_DTYPES).
    query_gradient_storage_dtype: Optional[Any] = None

    def __post_init__(self) -> None:
        if self.damping_factor is not None and self.damping_factor < 0:
            raise ValueError("`damping_factor` must be non-negative or None.")
        if self.query_gradient_storage_dtype is not None:
            try:
                dt = canonical_dtype_name(self.query_gradient_storage_dtype)
            except ValueError:
                dt = str(self.query_gradient_storage_dtype)
            if dt not in STORAGE_DTYPES:
                raise ValueError(
                    "`query_gradient_storage_dtype` must be one of "
                    f"{STORAGE_DTYPES} or None, got {self.query_gradient_storage_dtype!r}."
                )
        for name in ("data_partitions", "module_partitions"):
            if getattr(self, name) <= 0:
                raise ValueError(f"`{name}` must be positive.")
        if (
            self.query_gradient_accumulation_steps is not None
            and self.query_gradient_accumulation_steps <= 0
        ):
            raise ValueError(
                "`query_gradient_accumulation_steps` must be positive or None (auto)."
            )
        if self.query_gradient_low_rank is not None and self.query_gradient_low_rank <= 0:
            raise ValueError("`query_gradient_low_rank` must be positive or None.")
