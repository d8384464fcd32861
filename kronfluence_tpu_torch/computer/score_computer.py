"""ScoreComputer: orchestration for pairwise and self-influence scores.

Port of `kronfluence_tpu/computer/score_computer.py`: skip-if-exists,
score-argument persistence, flag-compatibility validation, (data x module)
partitions with concatenation and sum aggregation, and query/train index
subsets. Factors are loaded onto the analysis device. On a data mesh every
rank scores its rows and holds the assembled scores; rank 0 writes them,
then a barrier.
"""

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch

from kronfluence_tpu_torch.arguments import ScoreArguments
from kronfluence_tpu_torch.computer.computer import Computer, example_indices
from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
from kronfluence_tpu_torch.score.self_scores import compute_self_scores_with_loaders
from kronfluence_tpu_torch.utils.constants import SCORE_ARGUMENTS_NAME
from kronfluence_tpu_torch.utils.dataset import make_indices_partition
from kronfluence_tpu_torch.utils.save import load_file, save_file

ScoreDict = Dict[str, torch.Tensor]


def pairwise_scores_save_path(output_dir: Path, partition=None) -> Path:
    if partition is not None:
        di, mi = partition
        return Path(output_dir) / (
            f"pairwise_scores_data_partition{di}_module_partition{mi}.safetensors"
        )
    return Path(output_dir) / "pairwise_scores.safetensors"


def self_scores_save_path(output_dir: Path, partition=None) -> Path:
    if partition is not None:
        di, mi = partition
        return Path(output_dir) / (
            f"self_scores_data_partition{di}_module_partition{mi}.safetensors"
        )
    return Path(output_dir) / "self_scores.safetensors"


def _aggregate_scores(partition_results: List[List[ScoreDict]], concat_axis: int) -> ScoreDict:
    """Sums across module partitions, then concatenates the data partitions
    along the train axis."""
    data_chunks: List[ScoreDict] = []
    for row in partition_results:
        merged: ScoreDict = {}
        for scores in row:
            for key, val in scores.items():
                merged[key] = merged[key] + val if key in merged else val
        data_chunks.append(merged)
    return {
        key: torch.cat([chunk[key] for chunk in data_chunks], dim=concat_axis)
        for key in data_chunks[0]
    }


class ScoreComputer(Computer):
    def _validate_pairwise_flags(self, score_args: ScoreArguments) -> ScoreArguments:
        """A validated copy; the caller's arguments are never changed."""
        if score_args.compute_per_token_scores and (
            score_args.aggregate_train_gradients
            or score_args.aggregate_query_gradients
            or self.task.enable_post_process_per_sample_gradient
        ):
            self.logger.warning(
                "Per-token scores are incompatible with gradient aggregation / "
                "post-processing; falling back to per-sequence scores."
            )
            score_args = dataclasses.replace(score_args, compute_per_token_scores=False)
        if score_args.query_gradient_storage_dtype is not None and (
            score_args.aggregate_query_gradients or score_args.query_gradient_low_rank is not None
        ):
            self.logger.warning(
                "query_gradient_storage_dtype is ignored for aggregated or low-rank query "
                "gradients (those blocks are already small); proceeding without quantized "
                "storage."
            )
            score_args = dataclasses.replace(score_args, query_gradient_storage_dtype=None)
        return score_args

    def compute_pairwise_scores(
        self,
        scores_name: str,
        factors_name: str,
        query_dataset: Any,
        train_dataset: Any,
        per_device_query_batch_size: int,
        per_device_train_batch_size: Optional[int] = None,
        initial_per_device_train_batch_size_attempt: int = 4096,
        query_indices: Optional[Sequence[int]] = None,
        train_indices: Optional[Sequence[int]] = None,
        dataloader_kwargs=None,
        score_args: Optional[ScoreArguments] = None,
        target_data_partitions: Optional[Sequence[int]] = None,
        target_module_partitions: Optional[Sequence[int]] = None,
        overwrite_output_dir: bool = False,
    ) -> None:
        score_args = dataclasses.replace(score_args) if score_args else ScoreArguments()
        scores_dir = self.scores_output_dir(scores_name)
        scores_dir.mkdir(parents=True, exist_ok=True)
        if self._agreed(
            pairwise_scores_save_path(scores_dir).exists() and not overwrite_output_dir
        ):
            self.logger.info(f"Found existing pairwise scores at {scores_dir}. Skipping.")
            return
        score_args = self._validate_pairwise_flags(score_args)
        self._save_arguments(SCORE_ARGUMENTS_NAME, score_args, scores_dir, overwrite_output_dir)
        self._save_dataset_metadata(
            "query", query_dataset, scores_dir, overwrite_output_dir, query_indices
        )
        self._save_dataset_metadata(
            "train", train_dataset, scores_dir, overwrite_output_dir, train_indices
        )
        factor_args = self.loaded_factor_args(factors_name)
        with self.profiler.profile("Load All Factors"):
            factors = self.load_all_factors(factors_name)
        query_loader = self._get_loader(
            query_dataset, per_device_query_batch_size, query_indices,
            dataloader_kwargs=dataloader_kwargs, stage="pairwise", score_args=score_args,
        )
        train_idx = example_indices(train_dataset, train_indices)
        module_groups = self._partition_module_names(
            self.tracked_module_names(train_dataset), score_args.module_partitions
        )
        data_ranges = make_indices_partition(len(train_idx), score_args.data_partitions)
        # The query block the train pass holds, when its size is set (one
        # row with aggregated query gradients).
        steps = score_args.query_gradient_accumulation_steps
        resident = min(steps * query_loader.batch_size, query_loader.num_examples) if steps else 0
        if score_args.aggregate_query_gradients:
            resident = 1

        def compute_partition(di, mi):
            train_loader = self._get_loader(
                train_dataset, per_device_train_batch_size,
                train_idx[slice(*data_ranges[di])], initial_per_device_train_batch_size_attempt,
                dataloader_kwargs=dataloader_kwargs, stage="pairwise", score_args=score_args,
                resident_queries=resident,
            )
            with self.profiler.profile("Compute Pairwise Score"):
                return compute_pairwise_scores_with_loaders(
                    self.model, self.task, query_loader, train_loader, factors, factor_args,
                    score_args,
                    tracked_names=module_groups[mi] if len(module_groups) > 1 else None,
                    profiler=self.profiler, mesh=self.mesh,
                )

        aggregated = self._run_score_partitions(
            compute_partition, score_args, target_data_partitions, target_module_partitions,
            scores_dir, pairwise_scores_save_path, concat_axis=1,
            overwrite_output_dir=overwrite_output_dir,
        )
        if aggregated is not None:  # else a target subset: per-partition artifacts only
            with self.profiler.profile("Save Pairwise Score"):
                if self.writes_artifacts:
                    save_file(aggregated, pairwise_scores_save_path(scores_dir))
            self.logger.info(f"Saved pairwise scores at {scores_dir}.")
        self._synchronize("pairwise scores saved")
        if aggregated is not None:
            self._save_profile_summary("pairwise_score")

    def _run_score_partitions(
        self,
        compute_partition,
        score_args: ScoreArguments,
        target_data_partitions,
        target_module_partitions,
        scores_dir: Path,
        save_path_fn,
        concat_axis: int,
        overwrite_output_dir: bool,
    ) -> Optional[ScoreDict]:
        """The (data x module) partition loop: every partition is saved and
        skipped on a rerun; with `target_*_partitions` only those run and the
        aggregation waits for a full run."""
        partitioned = score_args.data_partitions > 1 or score_args.module_partitions > 1
        data_targets = (
            list(range(score_args.data_partitions)) if target_data_partitions is None
            else list(target_data_partitions)
        )
        module_targets = (
            list(range(score_args.module_partitions)) if target_module_partitions is None
            else list(target_module_partitions)
        )
        results: Dict[tuple, ScoreDict] = {}
        for di in data_targets:
            for mi in module_targets:
                partition = (di, mi)
                path = save_path_fn(scores_dir, partition) if partitioned else None
                if self._agreed(partitioned and path.exists() and not overwrite_output_dir):
                    self.logger.info(f"Found existing scores for partition {partition}. Skipping.")
                    results[partition] = load_file(path)
                    continue
                scores = compute_partition(di, mi)
                if partitioned and self.writes_artifacts:
                    save_file(scores, path)
                    self.logger.info(f"Saved scores for partition {partition}.")
                results[partition] = scores

        if target_data_partitions is not None or target_module_partitions is not None:
            return None
        return _aggregate_scores(
            [
                [results[(di, mi)] for mi in range(score_args.module_partitions)]
                for di in range(score_args.data_partitions)
            ],
            concat_axis=concat_axis,
        )

    def compute_self_scores(
        self,
        scores_name: str,
        factors_name: str,
        train_dataset: Any,
        per_device_train_batch_size: Optional[int] = None,
        initial_per_device_train_batch_size_attempt: int = 4096,
        train_indices: Optional[Sequence[int]] = None,
        dataloader_kwargs=None,
        score_args: Optional[ScoreArguments] = None,
        target_data_partitions: Optional[Sequence[int]] = None,
        target_module_partitions: Optional[Sequence[int]] = None,
        overwrite_output_dir: bool = False,
    ) -> None:
        # Self-influence drops the options that do not apply, on a copy.
        score_args = dataclasses.replace(
            score_args or ScoreArguments(),
            query_gradient_accumulation_steps=1,
            query_gradient_low_rank=None,
            aggregate_query_gradients=False,
            aggregate_train_gradients=False,
            compute_per_token_scores=False,
            query_gradient_storage_dtype=None,
        )
        scores_dir = self.scores_output_dir(scores_name)
        scores_dir.mkdir(parents=True, exist_ok=True)
        if self._agreed(self_scores_save_path(scores_dir).exists() and not overwrite_output_dir):
            self.logger.info(f"Found existing self scores at {scores_dir}. Skipping.")
            return
        self._save_arguments(SCORE_ARGUMENTS_NAME, score_args, scores_dir, overwrite_output_dir)
        self._save_dataset_metadata(
            "train", train_dataset, scores_dir, overwrite_output_dir, train_indices
        )
        factor_args = self.loaded_factor_args(factors_name)
        with self.profiler.profile("Load All Factors"):
            factors = self.load_all_factors(factors_name)
        train_idx = example_indices(train_dataset, train_indices)
        module_groups = self._partition_module_names(
            self.tracked_module_names(train_dataset), score_args.module_partitions
        )
        data_ranges = make_indices_partition(len(train_idx), score_args.data_partitions)

        def compute_partition(di, mi):
            train_loader = self._get_loader(
                train_dataset, per_device_train_batch_size,
                train_idx[slice(*data_ranges[di])], initial_per_device_train_batch_size_attempt,
                dataloader_kwargs=dataloader_kwargs, stage="self", score_args=score_args,
            )
            with self.profiler.profile("Compute Self-Influence Score"):
                return compute_self_scores_with_loaders(
                    self.model, self.task, train_loader, factors, factor_args, score_args,
                    tracked_names=module_groups[mi] if len(module_groups) > 1 else None,
                    mesh=self.mesh,
                )

        aggregated = self._run_score_partitions(
            compute_partition, score_args, target_data_partitions, target_module_partitions,
            scores_dir, self_scores_save_path, concat_axis=0,
            overwrite_output_dir=overwrite_output_dir,
        )
        if aggregated is not None:
            with self.profiler.profile("Save Self-Influence Score"):
                if self.writes_artifacts:
                    save_file(aggregated, self_scores_save_path(scores_dir))
            self.logger.info(f"Saved self-influence scores at {scores_dir}.")
        self._synchronize("self scores saved")
        if aggregated is not None:
            self._save_profile_summary("self_score")

    def load_pairwise_scores(self, scores_name: str) -> ScoreDict:
        return load_file(pairwise_scores_save_path(self.scores_output_dir(scores_name)))

    def load_self_scores(self, scores_name: str) -> ScoreDict:
        return load_file(self_scores_save_path(self.scores_output_dir(scores_name)))
