"""Computer base: device, output layout, argument and metadata persistence,
loaders, module partitions and factor loading.

Port of `kronfluence_tpu/computer/computer.py`: the directory layout
`{output_dir}/{name}/factors_{fname}|scores_{sname}`, the argument-conflict
check on the key intersection, and the strategy-driven `load_all_factors`.
The device is explicit: `cuda:0` unless `cpu=True`, or the device of the
data mesh the caller passes (`parallel/mesh.py`); the model is moved there.
On a mesh every rank runs every stage on its rows of each global batch of
`per_device_batch_size x ranks`; rank 0 alone writes artifacts, arguments
and metadata, then a barrier lets every rank read them, and every decision
to skip a stage is rank 0's.
"""

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from kronfluence_tpu_torch.arguments import Arguments, FactorArguments, ScoreArguments
from kronfluence_tpu_torch.factor import io as factor_io
from kronfluence_tpu_torch.factor.config import get_factor_config
from kronfluence_tpu_torch.factor.covariance import discover_stage_specs
from kronfluence_tpu_torch.parallel.distributed import sync_global_devices
from kronfluence_tpu_torch.parallel.mesh import Mesh, agree_flag, agree_min, data_axis_size
from kronfluence_tpu_torch.prepare import PreparedModel, prepare_model
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.constants import (
    FACTOR_ARGUMENTS_NAME,
    FACTOR_SAVE_PREFIX,
    SCORE_ARGUMENTS_NAME,
    SCORE_SAVE_PREFIX,
)
from kronfluence_tpu_torch.utils import memory
from kronfluence_tpu_torch.utils.dataset import (
    BatchLoader,
    DataLoaderKwargs,
    ProgressLoader,
    dataset_length,
    dataset_metadata,
)
from kronfluence_tpu_torch.utils.exceptions import FactorsNotFoundError
from kronfluence_tpu_torch.utils.logger import (
    PassThroughProfiler,
    Profiler,
    TraceProfiler,
    get_logger,
)
from kronfluence_tpu_torch.utils.save import load_json, save_json


def analysis_device(cpu: bool, mesh: Optional[Mesh] = None) -> torch.device:
    """The mesh's device, else `cuda:0`, or the CPU when asked; never the CPU
    in place of a missing card."""
    if mesh is not None:
        if cpu and mesh.device.type != "cpu":
            raise ValueError(f"`cpu=True` with a mesh on {mesh.device}: name one device.")
        device = mesh.device
    else:
        device = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available. Pass `cpu=True` to run the analysis on the CPU."
        )
    return device


class Computer:
    """Base orchestration shared by FactorComputer and ScoreComputer."""

    def __init__(
        self,
        name: str,
        model: Any,
        task: Task,
        mesh: Optional[Mesh] = None,
        cpu: bool = False,
        log_level: Optional[int] = None,
        log_main_process_only: bool = True,
        profile: Any = False,
        disable_tqdm: bool = False,
        output_dir: str = "./influence_results",
    ) -> None:
        self.name = name
        self.task = task
        self.mesh = mesh
        self.device = analysis_device(cpu, mesh)
        self.model: PreparedModel = prepare_model(model, task)
        self.model.module.to(self.device)
        self.disable_tqdm = disable_tqdm
        # Background artifact writes (perform_eigendecomposition async_save).
        self._pending_saves: list = []
        self.logger = get_logger(
            type(self).__name__, log_level, main_process_only=log_main_process_only
        )
        if profile == "trace":
            self.profiler = TraceProfiler(str(Path(output_dir) / "profiler_output"))
        else:
            self.profiler = Profiler() if profile else PassThroughProfiler()
        self.output_dir = Path(output_dir).joinpath(name).resolve()
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self._dataloader_params = DataLoaderKwargs()
        self._specs_cache: Optional[Dict[str, Any]] = None
        self.last_batch_estimate: Optional[Dict[str, Any]] = None

    # -- Ranks: who writes, what all agree on. --
    @property
    def writes_artifacts(self) -> bool:
        """Whether this process writes the artifacts: rank 0 of the mesh, or
        the process of an analysis without one."""
        return self.mesh is None or self.mesh.rank == 0

    def _agreed(self, flag: bool) -> bool:
        """Rank 0's decision on every rank (a skip, a conflict)."""
        return agree_flag(self.mesh, flag)

    def _synchronize(self, tag: str) -> None:
        """A barrier after rank 0's writes, before any rank reads them."""
        if self.mesh is not None:
            sync_global_devices(tag)

    def _save_profile_summary(self, stage_name: str) -> None:
        """Writes the profiler table of a stage to
        `{output}/profiler_output/{stage}_rank_{rank}_{time}.txt`, one file a
        rank."""
        summary = self.profiler.summary()
        if not summary:
            return
        profile_dir = self.output_dir / "profiler_output"
        profile_dir.mkdir(parents=True, exist_ok=True)
        rank = 0 if self.mesh is None else self.mesh.rank
        path = profile_dir / f"{stage_name}_rank_{rank}_{int(time.time())}.txt"
        path.write_text(summary + "\n")
        self.logger.info(f"Saved profiler summary at {path}.")

    # -- Directory layout. --
    def factors_output_dir(self, factors_name: str) -> Path:
        return (self.output_dir / (FACTOR_SAVE_PREFIX + factors_name)).resolve()

    def scores_output_dir(self, scores_name: str) -> Path:
        return (self.output_dir / (SCORE_SAVE_PREFIX + scores_name)).resolve()

    # -- Argument and metadata persistence. --
    def _save_arguments(
        self,
        arguments_name: str,
        arguments: Arguments,
        output_dir: Path,
        overwrite_output_dir: bool,
    ) -> None:
        path = output_dir / f"{arguments_name}_arguments.json"
        arg_dict = arguments.to_dict()
        conflict = False
        if self.writes_artifacts and path.exists() and not overwrite_output_dir:
            existing = load_json(path)
            # Compared on the key intersection, as the JAX package does:
            # artifacts written before a field existed run at its default.
            shared = set(existing) & set(arg_dict)
            conflict = {k: existing[k] for k in shared} != {k: arg_dict[k] for k in shared}
            if not conflict and set(arg_dict) - set(existing):
                self.logger.info(
                    f"Existing arguments at {path} predate fields "
                    f"{sorted(set(arg_dict) - set(existing))}; continuing with defaults."
                )
        elif self.writes_artifacts:
            save_json(arg_dict, path)
        if self._agreed(conflict):
            raise ValueError(
                f"Found existing arguments at {path} that differ from the current "
                "ones. Use `overwrite_output_dir=True` to overwrite."
            )

    def _load_arguments(self, arguments_name: str, output_dir: Path) -> Optional[Dict]:
        path = output_dir / f"{arguments_name}_arguments.json"
        return load_json(path) if path.exists() else None

    def _save_dataset_metadata(
        self,
        dataset_name: str,
        dataset: Any,
        output_dir: Path,
        overwrite_output_dir: bool,
        indices: Optional[Sequence[int]] = None,
    ) -> None:
        path = output_dir / f"{dataset_name}_dataset_metadata.json"
        metadata = dataset_metadata(dataset, indices)
        conflict = False
        if self.writes_artifacts and path.exists() and not overwrite_output_dir:
            conflict = load_json(path) != metadata
        elif self.writes_artifacts:
            save_json(metadata, path)
        if self._agreed(conflict):
            raise ValueError(
                f"Found existing dataset metadata at {path} that differs from the "
                "current dataset. Use `overwrite_output_dir=True` to overwrite."
            )

    # -- Loaders and batch sizing. --
    def global_batch_size(self, per_device_batch_size: int) -> int:
        return per_device_batch_size * data_axis_size(self.mesh)

    def _get_loader(
        self,
        dataset: Any,
        per_device_batch_size: Optional[int],
        indices: Optional[Sequence[int]] = None,
        initial_per_device_batch_size_attempt: int = 4096,
        dataloader_kwargs: Optional[DataLoaderKwargs] = None,
        stage: Optional[str] = None,
        factor_args: Optional[FactorArguments] = None,
        score_args: Optional[ScoreArguments] = None,
        resident_queries: int = 0,
    ) -> ProgressLoader:
        dataloader_kwargs = dataloader_kwargs or self._dataloader_params
        if per_device_batch_size is None:
            total = len(indices) if indices is not None else dataset_length(dataset)
            per_device_batch_size = self._find_executable_batch_size(
                dataset, total, initial_per_device_batch_size_attempt, stage=stage,
                factor_args=factor_args, score_args=score_args,
                dataloader_kwargs=dataloader_kwargs, resident_queries=resident_queries,
            )
        loader = BatchLoader(
            dataset,
            self.global_batch_size(per_device_batch_size),
            indices,
            device=self.device,
            dataloader_kwargs=dataloader_kwargs,
            mesh=self.mesh,
        )
        disable = self.disable_tqdm or not self.writes_artifacts
        return ProgressLoader(loader, self.logger, desc="Batches", disable=disable)

    def _find_executable_batch_size(
        self,
        dataset: Any,
        total: int,
        initial_attempt: int,
        stage: Optional[str] = None,
        factor_args: Optional[FactorArguments] = None,
        score_args: Optional[ScoreArguments] = None,
        dataloader_kwargs: Optional[DataLoaderKwargs] = None,
        resident_queries: int = 0,
    ) -> int:
        """The memory model's batch size for `stage` (utils/memory.py): the
        attempt clamped to the examples, probed on one example.

        On the card the port plans what the JAX model leaves out: per
        example, what torch's autograd keeps (`autograd_bytes`, twice for
        self-influence through the measurement, whose capture runs beside the
        loss's), for self-influence the arrays its eager preconditioning
        holds (`precondition_bytes`), and, for a pairwise train pass, the
        `resident_queries` query gradients held beside it. On the CPU the
        batch is the JAX package's. An estimation error raises: a guess in
        its place could exceed the card's memory later in the stage. On a
        mesh the attempt is divided over the ranks, and every rank takes the
        least of their estimates (two ranks sharing a card see each other's
        allocations)."""
        stage = stage or "covariance"
        attempt = max(1, min(initial_attempt, total) // data_axis_size(self.mesh))
        batch, _ = BatchLoader(
            dataset, 1, device=self.device, dataloader_kwargs=dataloader_kwargs
        ).probe()
        probes = memory.probe_modules(self.model, self.task, batch, 1)
        if not probes:
            raise FactorsNotFoundError("No tracked modules found in the model.")
        args = factor_args if factor_args is not None else score_args
        untracked = reserved = precondition = 0.0
        if self.device.type == "cuda":
            untracked = memory.autograd_bytes(
                self.model, self.task, batch, 1,
                remat=bool(args is not None and args.offload_activations_to_cpu),
                amp_dtype=args.amp_dtype if args is not None else None,
            )
            if stage == "self":
                if score_args.use_measurement_for_self_influence:
                    untracked *= 2
                precondition = memory.precondition_bytes(probes, score_args)
            if resident_queries:
                reserved = memory.query_block_bytes(probes, score_args, resident_queries)
        budget = memory.device_memory_budget(self.device)
        fit = memory.estimate_batch_size(
            probes, stage, params=self.model.module, factor_args=factor_args,
            score_args=score_args, budget_bytes=budget - reserved, max_batch_size=attempt,
            untracked_bytes=untracked + precondition,
        )
        fit = agree_min(self.mesh, fit)
        if fit < attempt:
            self.logger.info(
                f"Memory estimate reduced the per-device batch size {attempt} -> {fit} "
                f"for stage {stage!r}."
            )
        # What the last estimate planned, kept only for checks (chip_smoke.py
        # prints it beside the measured peak); nothing in the package reads it.
        self.last_batch_estimate = dict(
            stage=stage, attempt=attempt, batch_size=fit, budget_bytes=budget,
            reserved_bytes=reserved,
            static_bytes=memory.static_bytes(probes, stage, self.model.module),
            per_example_bytes=memory.stage_per_example_bytes(
                probes, stage, factor_args=factor_args, score_args=score_args
            ),
            untracked_bytes=untracked, precondition_bytes=precondition,
        )
        return fit

    # -- Module discovery and partitions. --
    def _layer_specs(self, dataset: Any = None) -> Dict[str, Any]:
        if self._specs_cache is None:
            if dataset is None:
                raise RuntimeError(
                    "Tracked modules are unknown until a dataset has been seen; run a "
                    "factor/score stage first or pass a dataset."
                )
            batch, _ = BatchLoader(dataset, 1, device=self.device).probe()
            self._specs_cache = discover_stage_specs(self.model, self.task, batch)
            if not self._specs_cache:
                raise FactorsNotFoundError("No tracked modules found in the model.")
        return self._specs_cache

    def tracked_module_names(self, dataset: Any = None) -> List[str]:
        return sorted(self._layer_specs(dataset))

    def _partition_module_names(
        self, module_names: List[str], module_partitions: int
    ) -> List[List[str]]:
        return [list(chunk) for chunk in np.array_split(module_names, module_partitions)]

    # -- Factor loading. --
    def load_all_factors(self, factors_name: str) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every artifact the fitted strategy needs for preconditioning, on
        the analysis device."""
        factors_dir = self.factors_output_dir(factors_name)
        saved_args = self._load_arguments(FACTOR_ARGUMENTS_NAME, factors_dir)
        config = get_factor_config((saved_args or {}).get("strategy", "ekfac"))
        factors: Dict[str, Dict[str, torch.Tensor]] = {}
        if config.requires_covariance_matrices_for_precondition:
            factors.update(factor_io.load_covariance_matrices(factors_dir, device=self.device))
        if config.requires_eigendecomposition_for_precondition:
            if not factor_io.eigendecomposition_exist(factors_dir):
                raise FactorsNotFoundError(
                    f"Eigendecomposition results not found in {factors_dir}."
                )
            factors.update(factor_io.load_eigendecomposition(factors_dir, device=self.device))
        if config.requires_lambda_matrices_for_precondition:
            if not factor_io.lambda_matrices_exist(factors_dir):
                raise FactorsNotFoundError(f"Lambda matrices not found in {factors_dir}.")
            factors.update(factor_io.load_lambda_matrices(factors_dir, device=self.device))
        return factors

    def _load_args_as(self, cls, arguments_name: str, output_dir: Path):
        """Persisted arguments JSON -> dataclass, dropping unknown fields."""
        saved = self._load_arguments(arguments_name, output_dir)
        if saved is None:
            return None
        known = {f.name for f in cls.__dataclass_fields__.values()}
        return cls(**{k: v for k, v in saved.items() if k in known})

    def load_factor_args(self, factors_name: str) -> Optional[FactorArguments]:
        """The persisted FactorArguments of `factors_name`, or None when never fitted."""
        return self._load_args_as(
            FactorArguments, FACTOR_ARGUMENTS_NAME, self.factors_output_dir(factors_name)
        )

    def load_score_args(self, scores_name: str) -> Optional[ScoreArguments]:
        """The persisted ScoreArguments of `scores_name`, or None when never computed."""
        return self._load_args_as(
            ScoreArguments, SCORE_ARGUMENTS_NAME, self.scores_output_dir(scores_name)
        )

    def loaded_factor_args(self, factors_name: str) -> FactorArguments:
        """`load_factor_args`, or the default arguments when never fitted."""
        return self.load_factor_args(factors_name) or FactorArguments()


def example_indices(dataset: Any, indices: Optional[Sequence[int]]) -> np.ndarray:
    """The example indices a stage runs over: `indices`, or the whole dataset."""
    if indices is not None:
        return np.asarray(indices, dtype=np.int64)
    return np.arange(dataset_length(dataset))
