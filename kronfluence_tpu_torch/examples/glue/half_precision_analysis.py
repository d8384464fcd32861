"""bf16 against fp32 pairwise-score fidelity on GLUE.

Port of `examples/glue/half_precision_analysis.py`: pairwise scores twice on
the same model and data, with the fp32 recipe and with the all-low-precision
bf16 recipe (`all_low_precision_factor_arguments`,
`all_low_precision_score_arguments`), and their Pearson and Spearman
correlations over every (query, train) pair.

    python -m kronfluence_tpu_torch.examples.glue.half_precision_analysis --num_train 256
"""

import argparse

import numpy as np

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.evaluate import spearman_correlation
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.glue.pipeline import construct_classifier, get_sst2_dataset
from kronfluence_tpu_torch.utils.common.factor_arguments import (
    all_low_precision_factor_arguments,
)
from kronfluence_tpu_torch.utils.common.score_arguments import (
    all_low_precision_score_arguments,
)

RECIPES = {
    "fp32": lambda: (FactorArguments(strategy="ekfac"), ScoreArguments()),
    "bf16": lambda: (all_low_precision_factor_arguments(strategy="ekfac", dtype="bfloat16"),
                     all_low_precision_score_arguments(dtype="bfloat16")),
}


def compare(module, task, train_data, query_data, batch_size: int, output_dir: str) -> dict:
    """Fits and scores `module` under each recipe, tagged "fp32" and "bf16"
    (an Analyzer "glue_half" that finds a tag's factors or scores on disk
    reuses them); returns the bf16 scores' Pearson and Spearman correlations
    with the fp32 scores."""
    device = next(module.parameters()).device
    analyzer = Analyzer("glue_half", prepare_model(module, task), task,
                        cpu=device.type == "cpu", output_dir=output_dir)
    scores = {}
    for tag, recipe in RECIPES.items():
        factor_args, score_args = recipe()
        analyzer.fit_all_factors(tag, train_data, per_device_batch_size=batch_size,
                                 factor_args=factor_args)
        analyzer.compute_pairwise_scores(
            tag, tag, query_data, train_data,
            per_device_query_batch_size=len(query_data["label"]),
            per_device_train_batch_size=batch_size, score_args=score_args,
        )
        scores[tag] = (analyzer.load_pairwise_scores(tag)["all_modules"]
                       .double().cpu().numpy().ravel())
        analyzer.release_memory()
    pearson = float(np.corrcoef(scores["fp32"], scores["bf16"])[0, 1])
    spearman = float(spearman_correlation(scores["fp32"], scores["bf16"])[0])
    return {"pearson": pearson, "spearman": spearman}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--output_dir", default="./influence_results/glue_half")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data = get_sst2_dataset("train", args.num_train)
    query_data = get_sst2_dataset("eval", args.num_query, seed=1)
    module, task = construct_classifier(device=device)
    results = compare(module, task, train_data, query_data, args.batch_size, args.output_dir)
    print(f"pairwise bf16 vs fp32: pearson={results['pearson']:.4f} "
          f"spearman={results['spearman']:.4f}")
    return results


if __name__ == "__main__":
    main()
