"""Analyzer: the public entry point. Port of `kronfluence_tpu/analyzer.py`.

`Analyzer(FactorComputer, ScoreComputer)` fits factors and computes pairwise
and self-influence scores, persisting every artifact under the JAX
package's names and layout, so either package reads the other's factor
directories. The analysis runs on `cuda:0`, where the model is moved, unless
`cpu=True`; without a CUDA card and without `cpu=True` it raises. With a data
mesh (`parallel.make_mesh()`, in every process `torchrun` starts) it runs on
the mesh's device: each rank fits and scores its rows of every global batch,
every rank holds the reduced factors and the assembled scores, and rank 0
alone writes the artifacts.
"""

from pathlib import Path
from typing import Any, Dict, Optional

import torch

from kronfluence_tpu_torch.arguments import FactorArguments
from kronfluence_tpu_torch.computer.factor_computer import FactorComputer
from kronfluence_tpu_torch.computer.score_computer import ScoreComputer
from kronfluence_tpu_torch.utils.dataset import BatchLoader, DataLoaderKwargs
from kronfluence_tpu_torch.utils.save import load_file, save_file, verify_models_equivalence
from kronfluence_tpu_torch.utils.task_check import verify_task_configuration


class Analyzer(FactorComputer, ScoreComputer):
    """Computes influence factors and scores for a model and a task."""

    def __init__(
        self,
        analysis_name: str,
        model: Any,
        task: Any,
        mesh: Any = None,
        cpu: bool = False,
        log_level: Optional[int] = None,
        log_main_process_only: bool = True,
        profile: Any = False,
        disable_tqdm: bool = False,
        output_dir: str = "./influence_results",
        disable_model_save: bool = True,
    ) -> None:
        super().__init__(
            name=analysis_name,
            model=model,
            task=task,
            mesh=mesh,
            cpu=cpu,
            log_level=log_level,
            log_main_process_only=log_main_process_only,
            profile=profile,
            disable_tqdm=disable_tqdm,
            output_dir=output_dir,
        )
        if not disable_model_save:
            self._save_model()

    def set_dataloader_kwargs(self, dataloader_kwargs: DataLoaderKwargs) -> None:
        self._dataloader_params = dataloader_kwargs

    def _save_model(self) -> None:
        """Saves the analyzed parameters, or on a rerun checks that they are
        unchanged (rank 0's check and write on a mesh)."""
        model_save_path = self.output_dir / "model.safetensors"
        state = self.model.module.state_dict()
        differs = False
        if self.writes_artifacts and model_save_path.exists():
            differs = not verify_models_equivalence(load_file(model_save_path), state)
        elif self.writes_artifacts:
            save_file(state, model_save_path)
        if self._agreed(differs):
            raise ValueError(
                "Previously saved model parameters differ from the current "
                "parameters. Provide a different `analysis_name`."
            )
        self._synchronize("model saved")

    def fit_all_factors(
        self,
        factors_name: str,
        dataset: Any,
        per_device_batch_size: Optional[int] = None,
        initial_per_device_batch_size_attempt: int = 4096,
        dataloader_kwargs: Optional[DataLoaderKwargs] = None,
        factor_args: Optional[FactorArguments] = None,
        overwrite_output_dir: bool = False,
    ) -> None:
        """Covariance -> eigendecomposition -> lambda. The eigendecomposition
        reaches the lambda stage in memory, and its files are written on a
        background thread while the lambda stage runs."""
        self.fit_covariance_matrices(
            factors_name=factors_name,
            dataset=dataset,
            per_device_batch_size=per_device_batch_size,
            initial_per_device_batch_size_attempt=initial_per_device_batch_size_attempt,
            dataloader_kwargs=dataloader_kwargs,
            factor_args=factor_args,
            overwrite_output_dir=overwrite_output_dir,
        )
        eigen_factors = self.perform_eigendecomposition(
            factors_name=factors_name,
            factor_args=factor_args,
            overwrite_output_dir=overwrite_output_dir,
            return_in_memory=True,
            async_save=True,
        )
        try:
            self.fit_lambda_matrices(
                factors_name=factors_name,
                dataset=dataset,
                per_device_batch_size=per_device_batch_size,
                initial_per_device_batch_size_attempt=initial_per_device_batch_size_attempt,
                dataloader_kwargs=dataloader_kwargs,
                factor_args=factor_args,
                overwrite_output_dir=overwrite_output_dir,
                eigen_factors=eigen_factors,
            )
        finally:
            self.wait_for_async_saves()

    @staticmethod
    def load_file(path: Path) -> Dict[str, torch.Tensor]:
        """Loads a safetensors artifact file (CPU tensors)."""
        return load_file(Path(path))

    def verify_task(self, dataset: Any, per_device_batch_size: int = 8) -> None:
        """Probes one batch and raises `IllegalTaskConfigurationError` or
        `TrackedModuleNotFoundError` on common Task mistakes (a mean-reduced
        loss, a non-scalar measurement, a mis-shaped attention mask, unknown
        tracked-module names) before any stage runs."""
        batch, _ = BatchLoader(dataset, per_device_batch_size, device=self.device).probe()
        verify_task_configuration(self.model, self.task, batch)

    def release_memory(self) -> None:
        """Returns the CUDA caching allocator's unused blocks to the device."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def get_module_summary(self) -> str:
        """A summary of the tracked modules (known after a stage has run)."""
        lines = ["==Tracked Modules=="]
        for name, spec in self._layer_specs().items():
            lines.append(
                f"Module Name: `{name}`, kind: {spec.kind}, "
                f"activation_dim: {spec.activation_dim}, gradient_dim: {spec.gradient_dim}"
            )
        return "\n".join(lines)
