"""Artifact IO for factors. Port of `kronfluence_tpu/factor/io.py`.

The same file naming as the JAX package and the reference: one safetensors
file per factor name mapping module name -> tensor, with
`_data_partition{i}_module_partition{j}` suffixes when partitioned.
"""

from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from kronfluence_tpu_torch.utils.constants import (
    COVARIANCE_FACTOR_NAMES,
    EIGENDECOMPOSITION_FACTOR_NAMES,
    LAMBDA_FACTOR_NAMES,
    PARTITION_TYPE,
)
from kronfluence_tpu_torch.utils.save import HostFile, load_file, to_host, write_host_file

FactorDict = Dict[str, Dict[str, torch.Tensor]]  # factor_name -> module -> tensor


def factor_path(
    output_dir: Path, factor_name: str, partition: Optional[PARTITION_TYPE] = None
) -> Path:
    if partition is not None:
        data_partition, module_partition = partition
        return Path(output_dir) / (
            f"{factor_name}_data_partition{data_partition}"
            f"_module_partition{module_partition}.safetensors"
        )
    return Path(output_dir) / f"{factor_name}.safetensors"


def factors_to_host(
    factors: FactorDict, factor_names: List[str], metadata: Optional[Dict[str, str]] = None
) -> Dict[str, HostFile]:
    """One host copy per factor file; `write_factors` then does the file I/O."""
    if set(factors) != set(factor_names):
        raise ValueError(f"Factors {sorted(factors)} are not the set {sorted(factor_names)}.")
    return {name: to_host(tensors, metadata) for name, tensors in factors.items()}


def write_factors(
    output_dir: Path, host_files: Dict[str, HostFile], partition: Optional[PARTITION_TYPE] = None
) -> None:
    for factor_name, host in host_files.items():
        write_host_file(host, factor_path(output_dir, factor_name, partition))


def save_factors(
    output_dir: Path,
    factors: FactorDict,
    factor_names: List[str],
    partition: Optional[PARTITION_TYPE] = None,
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    write_factors(output_dir, factors_to_host(factors, factor_names, metadata), partition)


def load_factors(
    output_dir: Path,
    factor_names: List[str],
    partition: Optional[PARTITION_TYPE] = None,
    device: Any = "cpu",
) -> FactorDict:
    return {
        name: load_file(factor_path(output_dir, name, partition), device)
        for name in factor_names
    }


def factors_exist(
    output_dir: Path,
    factor_names: List[str],
    partition: Optional[PARTITION_TYPE] = None,
) -> bool:
    return all(factor_path(output_dir, name, partition).exists() for name in factor_names)


# Named helpers mirroring the reference per-stage functions.
def save_covariance_matrices(output_dir, factors, partition=None, metadata=None):
    save_factors(output_dir, factors, COVARIANCE_FACTOR_NAMES, partition, metadata)


def load_covariance_matrices(output_dir, partition=None, device="cpu"):
    return load_factors(output_dir, COVARIANCE_FACTOR_NAMES, partition, device)


def covariance_matrices_exist(output_dir, partition=None):
    return factors_exist(output_dir, COVARIANCE_FACTOR_NAMES, partition)


def save_eigendecomposition(output_dir, factors, metadata=None):
    save_factors(output_dir, factors, EIGENDECOMPOSITION_FACTOR_NAMES, None, metadata)


def load_eigendecomposition(output_dir, device="cpu"):
    return load_factors(output_dir, EIGENDECOMPOSITION_FACTOR_NAMES, None, device)


def eigendecomposition_exist(output_dir):
    return factors_exist(output_dir, EIGENDECOMPOSITION_FACTOR_NAMES)


def save_lambda_matrices(output_dir, factors, partition=None, metadata=None):
    save_factors(output_dir, factors, LAMBDA_FACTOR_NAMES, partition, metadata)


def load_lambda_matrices(output_dir, partition=None, device="cpu"):
    return load_factors(output_dir, LAMBDA_FACTOR_NAMES, partition, device)


def lambda_matrices_exist(output_dir, partition=None):
    return factors_exist(output_dir, LAMBDA_FACTOR_NAMES, partition)
