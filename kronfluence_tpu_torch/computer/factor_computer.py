"""FactorComputer: per-stage orchestration for covariance, eigendecomposition
and lambda.

Port of `kronfluence_tpu/computer/factor_computer.py`: skip-if-exists per
(data partition x module partition), argument and dataset-metadata
persistence, partition aggregation, and factor reuse through
`load_from_factors_name`. On a data mesh every rank fits its rows and the
stage functions all-reduce the sums; rank 0 writes the artifacts (and the
eigendecomposition's checkpoints), then a barrier; every rank
eigendecomposes the same factors.
"""

import shutil
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from kronfluence_tpu_torch.arguments import FactorArguments
from kronfluence_tpu_torch.computer.computer import Computer
from kronfluence_tpu_torch.factor import io as factor_io
from kronfluence_tpu_torch.factor.config import get_factor_config
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition as _perform_eigendecomposition,
)
from kronfluence_tpu_torch.utils.constants import (
    COVARIANCE_FACTOR_NAMES,
    EIGENDECOMPOSITION_FACTOR_NAMES,
    FACTOR_ARGUMENTS_NAME,
    LAMBDA_FACTOR_NAMES,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
    NUM_LAMBDA_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import dataset_length, make_indices_partition
from kronfluence_tpu_torch.utils.exceptions import FactorsNotFoundError
from kronfluence_tpu_torch.utils.logger import get_time

FactorDict = Dict[str, Dict[str, torch.Tensor]]


def _aggregate_sum(per_partition: List[FactorDict], count_names: Sequence[str]) -> FactorDict:
    """Sums factor dicts across partitions: counts exactly, matrices in fp64
    and back to their dtype, as the JAX package does."""
    out: FactorDict = {}
    for factors in per_partition:
        for factor_name, modules in factors.items():
            dest = out.setdefault(factor_name, {})
            for module_name, tensor in modules.items():
                if module_name not in dest:
                    dest[module_name] = tensor
                elif factor_name in count_names:
                    dest[module_name] = dest[module_name] + tensor
                else:
                    dest[module_name] = (
                        dest[module_name].to(torch.float64) + tensor.to(torch.float64)
                    ).to(tensor.dtype)
    return out


def _examples(dataset: Any, max_examples: Optional[int]) -> np.ndarray:
    total = dataset_length(dataset)
    return np.arange(min(total, max_examples) if max_examples else total)


class FactorComputer(Computer):
    def fit_covariance_matrices(
        self,
        factors_name: str,
        dataset: Any,
        per_device_batch_size: Optional[int] = None,
        initial_per_device_batch_size_attempt: int = 4096,
        dataloader_kwargs=None,
        factor_args: Optional[FactorArguments] = None,
        target_data_partitions: Optional[Sequence[int]] = None,
        target_module_partitions: Optional[Sequence[int]] = None,
        overwrite_output_dir: bool = False,
    ) -> None:
        factor_args = factor_args or FactorArguments()
        factors_dir = self.factors_output_dir(factors_name)
        factors_dir.mkdir(parents=True, exist_ok=True)
        if self._agreed(
            factor_io.covariance_matrices_exist(factors_dir) and not overwrite_output_dir
        ):
            self.logger.info(f"Found existing covariance matrices at {factors_dir}. Skipping.")
            return
        self._save_arguments(FACTOR_ARGUMENTS_NAME, factor_args, factors_dir, overwrite_output_dir)
        indices = _examples(dataset, factor_args.covariance_max_examples)
        self._save_dataset_metadata(
            "covariance", dataset, factors_dir, overwrite_output_dir,
            indices if len(indices) < dataset_length(dataset) else None,
        )
        self._run_partitioned_fit(
            stage="covariance",
            factor_args=factor_args,
            fit_fn=lambda loader, names: fit_covariance_matrices_with_loader(
                self.model, self.task, loader, factor_args, tracked_names=names, mesh=self.mesh
            ),
            dataset=dataset,
            indices=indices,
            per_device_batch_size=per_device_batch_size,
            initial_attempt=initial_per_device_batch_size_attempt,
            dataloader_kwargs=dataloader_kwargs,
            data_partitions=factor_args.covariance_data_partitions,
            module_partitions=factor_args.covariance_module_partitions,
            target_data_partitions=target_data_partitions,
            target_module_partitions=target_module_partitions,
            factors_dir=factors_dir,
            factor_names=COVARIANCE_FACTOR_NAMES,
            count_names=(NUM_ACTIVATION_COVARIANCE_PROCESSED, NUM_GRADIENT_COVARIANCE_PROCESSED),
            overwrite_output_dir=overwrite_output_dir,
        )

    def perform_eigendecomposition(
        self,
        factors_name: str,
        factor_args: Optional[FactorArguments] = None,
        overwrite_output_dir: bool = False,
        load_from_factors_name: Optional[str] = None,
        return_in_memory: bool = False,
        async_save: bool = False,
    ) -> Optional[FactorDict]:
        """Eigendecomposes the saved covariance factors.

        `return_in_memory=True` returns the eigen factors (on the analysis
        device) instead of None; on a skip it loads the saved ones.
        `async_save=True` copies them to the host once, then writes the files
        on a background thread, so the write overlaps what the caller runs
        next; `wait_for_async_saves()` joins it, and `fit_all_factors` does.
        On a mesh every rank solves, rank 0 alone writes (and keeps the
        checkpoints of the large solves).
        """
        factor_args = factor_args or self.loaded_factor_args(factors_name)
        config = get_factor_config(factor_args.strategy)
        factors_dir = self.factors_output_dir(factors_name)
        factors_dir.mkdir(parents=True, exist_ok=True)
        if not config.requires_eigendecomposition:
            self.logger.info(
                f"Strategy {factor_args.strategy!r} does not require eigendecomposition."
            )
            return None
        if self._agreed(factor_io.eigendecomposition_exist(factors_dir) and not overwrite_output_dir):
            self.logger.info(f"Found existing eigendecomposition at {factors_dir}. Skipping.")
            if not return_in_memory:
                return None
            return factor_io.load_eigendecomposition(factors_dir, device=self.device)
        source_dir = (
            self.factors_output_dir(load_from_factors_name)
            if load_from_factors_name
            else factors_dir
        )
        if not factor_io.covariance_matrices_exist(source_dir):
            raise FactorsNotFoundError(f"Covariance matrices not found in {source_dir}.")
        with self.profiler.profile("Load Covariance"):
            covariance = factor_io.load_covariance_matrices(source_dir, device=self.device)
        # Per-matrix checkpoints of the factors of dimension >= 6144, the
        # longest solves of the stage: a rerun after a failure resumes from
        # them. Removed once the artifact is saved.
        scratch_dir = factors_dir / "eigendecomposition_scratch"
        with self.profiler.profile("Perform Eigendecomposition"):
            eigen = _perform_eigendecomposition(
                covariance, factor_args,
                scratch_dir=scratch_dir if self.writes_artifacts else None,
            )
        del covariance
        # Profiled regions take every rank's clock (utils/logger.py:get_time):
        # each rank enters them, and only the writer does their work.
        with self.profiler.profile("Save Eigendecomposition (host copy)"):
            if self.writes_artifacts:
                host_files = factor_io.factors_to_host(eigen, EIGENDECOMPOSITION_FACTOR_NAMES)

        def _write() -> float:
            start = get_time(synchronize=False)
            factor_io.write_factors(factors_dir, host_files)
            shutil.rmtree(scratch_dir, ignore_errors=True)
            self.logger.info(f"Saved eigendecomposition results at {factors_dir}.")
            return get_time(synchronize=False) - start

        if self.writes_artifacts and async_save:
            box: Dict[str, Any] = {}

            def _run() -> None:
                try:
                    box["seconds"] = _write()
                except BaseException as exc:  # re-raised by wait_for_async_saves
                    box["exc"] = exc

            thread = threading.Thread(target=_run, daemon=True, name="kf-eigen-save")
            thread.start()
            self._pending_saves.append(("Save Eigendecomposition (write)", thread, box))
        elif self.writes_artifacts:
            self.profiler.record("Save Eigendecomposition (write)", _write())
        if not async_save:
            self._synchronize("eigendecomposition saved")
        self._save_profile_summary("eigendecomposition")
        return eigen if return_in_memory else None

    def wait_for_async_saves(self) -> None:
        """Joins background artifact writes started with `async_save=True`,
        re-raising the first failure (a missing artifact would break the
        skip-if-exists resume). On a mesh every rank calls it: a barrier
        follows rank 0's writes."""
        pending, self._pending_saves = self._pending_saves, []
        for action_name, thread, box in pending:
            thread.join()
            if "exc" in box:
                raise box["exc"]
            self.profiler.record(action_name, box["seconds"])
        self._synchronize("asynchronous saves done")

    def fit_lambda_matrices(
        self,
        factors_name: str,
        dataset: Any,
        per_device_batch_size: Optional[int] = None,
        initial_per_device_batch_size_attempt: int = 4096,
        dataloader_kwargs=None,
        factor_args: Optional[FactorArguments] = None,
        target_data_partitions: Optional[Sequence[int]] = None,
        target_module_partitions: Optional[Sequence[int]] = None,
        overwrite_output_dir: bool = False,
        load_from_factors_name: Optional[str] = None,
        eigen_factors: Optional[FactorDict] = None,
    ) -> None:
        """`eigen_factors`: in-memory eigendecomposition results (as returned
        by `perform_eigendecomposition(return_in_memory=True)`); when given,
        they are used in place of the saved ones."""
        factor_args = factor_args or self.loaded_factor_args(factors_name)
        config = get_factor_config(factor_args.strategy)
        factors_dir = self.factors_output_dir(factors_name)
        factors_dir.mkdir(parents=True, exist_ok=True)
        if not config.requires_lambda_matrices:
            self.logger.info(f"Strategy {factor_args.strategy!r} does not require Lambda matrices.")
            return
        if self._agreed(factor_io.lambda_matrices_exist(factors_dir) and not overwrite_output_dir):
            self.logger.info(f"Found existing Lambda matrices at {factors_dir}. Skipping.")
            return
        self._save_arguments(FACTOR_ARGUMENTS_NAME, factor_args, factors_dir, overwrite_output_dir)

        if not config.requires_eigendecomposition_for_lambda:
            eigen_factors = None
        elif eigen_factors is None:
            source_dir = (
                self.factors_output_dir(load_from_factors_name)
                if load_from_factors_name
                else factors_dir
            )
            if not factor_io.eigendecomposition_exist(source_dir):
                raise FactorsNotFoundError(f"Eigendecomposition results not found in {source_dir}.")
            with self.profiler.profile("Load Eigendecomposition"):
                eigen_factors = factor_io.load_eigendecomposition(source_dir, device=self.device)

        indices = _examples(dataset, factor_args.lambda_max_examples)
        self._save_dataset_metadata(
            "lambda", dataset, factors_dir, overwrite_output_dir,
            indices if len(indices) < dataset_length(dataset) else None,
        )
        self._run_partitioned_fit(
            stage="lambda",
            factor_args=factor_args,
            fit_fn=lambda loader, names: fit_lambda_matrices_with_loader(
                self.model, self.task, loader, factor_args,
                eigen_factors=eigen_factors, tracked_names=names, mesh=self.mesh,
            ),
            dataset=dataset,
            indices=indices,
            per_device_batch_size=per_device_batch_size,
            initial_attempt=initial_per_device_batch_size_attempt,
            dataloader_kwargs=dataloader_kwargs,
            data_partitions=factor_args.lambda_data_partitions,
            module_partitions=factor_args.lambda_module_partitions,
            target_data_partitions=target_data_partitions,
            target_module_partitions=target_module_partitions,
            factors_dir=factors_dir,
            factor_names=LAMBDA_FACTOR_NAMES,
            count_names=(NUM_LAMBDA_PROCESSED,),
            overwrite_output_dir=overwrite_output_dir,
        )

    def _run_partitioned_fit(
        self,
        stage: str,
        factor_args: FactorArguments,
        fit_fn,
        dataset,
        indices: np.ndarray,
        per_device_batch_size,
        initial_attempt: int,
        dataloader_kwargs,
        data_partitions: int,
        module_partitions: int,
        target_data_partitions,
        target_module_partitions,
        factors_dir,
        factor_names,
        count_names,
        overwrite_output_dir: bool,
    ) -> None:
        """Fits one stage over (data x module) partitions, each saved and
        skipped on a rerun, then sums them into the unpartitioned artifact
        (unless only some partitions were targeted)."""
        title = stage.capitalize()
        module_names = self.tracked_module_names(dataset)
        if data_partitions == 1 and module_partitions == 1:
            loader = self._get_loader(
                dataset, per_device_batch_size, indices, initial_attempt,
                dataloader_kwargs=dataloader_kwargs, stage=stage, factor_args=factor_args,
            )
            with self.profiler.profile(f"Fit {title}"):
                factors = fit_fn(loader, None)
            with self.profiler.profile(f"Save {title}"):
                if self.writes_artifacts:
                    factor_io.save_factors(factors_dir, factors, factor_names)
            self.logger.info(f"Saved {stage} factors at {factors_dir}.")
            self._synchronize(f"{stage} saved")
            self._save_profile_summary(stage)
            return

        module_groups = self._partition_module_names(module_names, module_partitions)
        data_ranges = make_indices_partition(len(indices), data_partitions)
        data_targets = (
            list(range(data_partitions)) if target_data_partitions is None
            else list(target_data_partitions)
        )
        module_targets = (
            list(range(module_partitions)) if target_module_partitions is None
            else list(target_module_partitions)
        )
        for di in data_targets:
            start, end = data_ranges[di]
            for mi in module_targets:
                partition = (di, mi)
                if self._agreed(factor_io.factors_exist(factors_dir, factor_names, partition)
                                and not overwrite_output_dir):
                    self.logger.info(
                        f"Found existing {stage} factors for partition {partition}. Skipping."
                    )
                    continue
                loader = self._get_loader(
                    dataset, per_device_batch_size, indices[start:end], initial_attempt,
                    dataloader_kwargs=dataloader_kwargs, stage=stage, factor_args=factor_args,
                )
                with self.profiler.profile(f"Fit {title}"):
                    factors = fit_fn(loader, module_groups[mi])
                with self.profiler.profile(f"Save {title}"):
                    if self.writes_artifacts:
                        factor_io.save_factors(factors_dir, factors, factor_names, partition)
                self.logger.info(f"Saved {stage} factors for partition {partition}.")
                del factors

        if target_data_partitions is None and target_module_partitions is None:
            with self.profiler.profile(f"Save {title}"):
                if self.writes_artifacts:
                    per_partition = [
                        factor_io.load_factors(factors_dir, factor_names, (di, mi))
                        for di in range(data_partitions)
                        for mi in range(module_partitions)
                    ]
                    factor_io.save_factors(
                        factors_dir, _aggregate_sum(per_partition, count_names), factor_names
                    )
            self.logger.info(f"Saved aggregated {stage} factors at {factors_dir}.")
        self._synchronize(f"{stage} saved")
        self._save_profile_summary(stage)

    # -- Accessors. --
    def load_covariance_matrices(self, factors_name: str) -> FactorDict:
        return factor_io.load_covariance_matrices(self.factors_output_dir(factors_name))

    def load_eigendecomposition(self, factors_name: str) -> FactorDict:
        return factor_io.load_eigendecomposition(self.factors_output_dir(factors_name))

    def load_lambda_matrices(self, factors_name: str) -> FactorDict:
        return factor_io.load_lambda_matrices(self.factors_output_dir(factors_name))
