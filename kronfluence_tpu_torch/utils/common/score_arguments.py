"""Named ScoreArguments recipes: port of
`kronfluence_tpu/utils/common/score_arguments.py`, the same recipes with the
same fields and defaults."""

from typing import Optional

from kronfluence_tpu_torch.arguments import ScoreArguments


def default_score_arguments(
    damping_factor: Optional[float] = 1e-08,
    query_gradient_low_rank: Optional[int] = None,
) -> ScoreArguments:
    score_args = ScoreArguments(
        damping_factor=damping_factor, query_gradient_low_rank=query_gradient_low_rank
    )
    if score_args.query_gradient_low_rank is not None:
        score_args.query_gradient_accumulation_steps = 10
    return score_args


def pytest_score_arguments(
    damping_factor: Optional[float] = 1e-08,
    query_gradient_low_rank: Optional[int] = None,
) -> ScoreArguments:
    score_args = ScoreArguments(
        damping_factor=damping_factor, query_gradient_low_rank=query_gradient_low_rank
    )
    score_args.query_gradient_svd_dtype = "float64"
    score_args.score_dtype = "float64"
    score_args.per_sample_gradient_dtype = "float64"
    score_args.precondition_dtype = "float64"
    return score_args


def smart_low_precision_score_arguments(
    damping_factor: Optional[float] = 1e-08,
    query_gradient_low_rank: Optional[int] = None,
    dtype: str = "bfloat16",
) -> ScoreArguments:
    score_args = default_score_arguments(
        damping_factor=damping_factor, query_gradient_low_rank=query_gradient_low_rank
    )
    score_args.amp_dtype = dtype
    score_args.score_dtype = dtype
    score_args.per_sample_gradient_dtype = dtype
    score_args.query_gradient_svd_dtype = "float32"
    score_args.precondition_dtype = "float32"
    return score_args


def all_low_precision_score_arguments(
    damping_factor: Optional[float] = 1e-08,
    query_gradient_low_rank: Optional[int] = None,
    dtype: str = "bfloat16",
) -> ScoreArguments:
    score_args = default_score_arguments(
        damping_factor=damping_factor, query_gradient_low_rank=query_gradient_low_rank
    )
    score_args.amp_dtype = dtype
    score_args.score_dtype = dtype
    score_args.per_sample_gradient_dtype = dtype
    score_args.precondition_dtype = dtype
    score_args.query_gradient_svd_dtype = "float32"
    return score_args


def reduce_memory_score_arguments(
    damping_factor: Optional[float] = 1e-08,
    query_gradient_low_rank: Optional[int] = None,
    dtype: str = "bfloat16",
) -> ScoreArguments:
    score_args = all_low_precision_score_arguments(
        damping_factor=damping_factor,
        query_gradient_low_rank=query_gradient_low_rank,
        dtype=dtype,
    )
    score_args.offload_activations_to_cpu = True
    return score_args


def extreme_reduce_memory_score_arguments(
    damping_factor: Optional[float] = 1e-08,
    module_partitions: int = 4,
    query_gradient_low_rank: Optional[int] = None,
    dtype: str = "bfloat16",
) -> ScoreArguments:
    score_args = reduce_memory_score_arguments(
        damping_factor=damping_factor,
        query_gradient_low_rank=query_gradient_low_rank,
        dtype=dtype,
    )
    score_args.module_partitions = module_partitions
    return score_args


def fp8_query_score_arguments(
    damping_factor: Optional[float] = None,
    query_gradient_low_rank: Optional[int] = None,
    dtype: str = "bfloat16",
) -> ScoreArguments:
    """bf16 compute with float8_e4m3fn resident query blocks, damping by the
    0.1 x mean-eigenvalue heuristic (``None``); the pairwise stage quantizes
    each module's preconditioned query gradient (ops/quantize.py)."""
    score_args = smart_low_precision_score_arguments(
        damping_factor=damping_factor,
        query_gradient_low_rank=query_gradient_low_rank,
        dtype=dtype,
    )
    score_args.query_gradient_storage_dtype = "float8_e4m3fn"
    return score_args
