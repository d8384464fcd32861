"""Named FactorArguments recipes: port of
`kronfluence_tpu/utils/common/factor_arguments.py`, the same recipes with the
same fields and defaults. `amp_dtype` casts the model for the forward and
backward; the per-stage dtype fields set factor accumulation precision."""

from kronfluence_tpu_torch.arguments import FactorArguments


def default_factor_arguments(strategy: str = "ekfac") -> FactorArguments:
    return FactorArguments(strategy=strategy)


def pytest_factor_arguments(strategy: str = "ekfac") -> FactorArguments:
    """fp64 + empirical Fisher: deterministic unit-test numerics."""
    factor_args = FactorArguments(strategy=strategy)
    factor_args.use_empirical_fisher = True
    factor_args.activation_covariance_dtype = "float64"
    factor_args.gradient_covariance_dtype = "float64"
    factor_args.per_sample_gradient_dtype = "float64"
    factor_args.lambda_dtype = "float64"
    return factor_args


def smart_low_precision_factor_arguments(
    strategy: str = "ekfac", dtype: str = "bfloat16"
) -> FactorArguments:
    """Low precision everywhere except Lambda accumulation."""
    factor_args = FactorArguments(strategy=strategy)
    factor_args.amp_dtype = dtype
    factor_args.activation_covariance_dtype = dtype
    factor_args.gradient_covariance_dtype = dtype
    factor_args.per_sample_gradient_dtype = dtype
    factor_args.lambda_dtype = "float32"
    return factor_args


def all_low_precision_factor_arguments(
    strategy: str = "ekfac", dtype: str = "bfloat16"
) -> FactorArguments:
    factor_args = FactorArguments(strategy=strategy)
    factor_args.amp_dtype = dtype
    factor_args.activation_covariance_dtype = dtype
    factor_args.gradient_covariance_dtype = dtype
    factor_args.per_sample_gradient_dtype = dtype
    factor_args.lambda_dtype = dtype
    return factor_args


def reduce_memory_factor_arguments(
    strategy: str = "ekfac", dtype: str = "bfloat16"
) -> FactorArguments:
    factor_args = all_low_precision_factor_arguments(strategy=strategy, dtype=dtype)
    factor_args.use_iterative_lambda_aggregation = True
    return factor_args


def extreme_reduce_memory_factor_arguments(
    strategy: str = "ekfac", module_partitions: int = 1, dtype: str = "bfloat16"
) -> FactorArguments:
    """For models that are difficult to fit on a single chip."""
    factor_args = reduce_memory_factor_arguments(strategy=strategy, dtype=dtype)
    factor_args.offload_activations_to_cpu = True
    factor_args.covariance_module_partitions = module_partitions
    factor_args.lambda_module_partitions = module_partitions
    return factor_args
