"""SWAG-style multiple-choice influence analysis.

Port of `examples/swag/analyze.py`: each example has 4 candidate endings,
scored by one shared encoder (the encoder runs 4 times an example, and each
example's 4 per-sample gradients are summed back to one), EK-FAC factors and
pairwise scores from rank-`--query_gradient_low_rank` query gradients.

    python -m kronfluence_tpu_torch.examples.swag.analyze --num_train 128 --query_gradient_low_rank 16
"""

import argparse

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.swag.pipeline import construct_choice_model, synthetic_swag


def analyze(module, task, train_data, query_data, batch_size: int, rank, output_dir: str):
    """The script's analysis of `module`: EK-FAC factors "ekfac" on
    `train_data` and pairwise scores "pairwise_qb" of every query in one
    batch, from rank-`rank` query gradients (None: full rank), against every
    train example; returns the Analyzer and the scores."""
    device = next(module.parameters()).device
    analyzer = Analyzer("swag", prepare_model(module, task), task, cpu=device.type == "cpu",
                        output_dir=output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    analyzer.compute_pairwise_scores(
        "pairwise_qb", "ekfac", query_data, train_data,
        per_device_query_batch_size=len(query_data["label"]),
        per_device_train_batch_size=batch_size,
        score_args=ScoreArguments(query_gradient_low_rank=rank),
    )
    return analyzer, analyzer.load_pairwise_scores("pairwise_qb")["all_modules"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=8)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--query_gradient_low_rank", type=int, default=16)
    parser.add_argument("--output_dir", default="./influence_results/swag")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    module, task = construct_choice_model(device=device)
    train_data = synthetic_swag(args.num_train, seed=0)
    query_data = synthetic_swag(args.num_query, seed=1)
    analyzer, scores = analyze(module, task, train_data, query_data, args.batch_size,
                               args.query_gradient_low_rank, args.output_dir)
    print(f"pairwise scores (low-rank queries): {tuple(scores.shape)}")
    print(analyzer.profiler.summary())
    return analyzer, scores


if __name__ == "__main__":
    main()
