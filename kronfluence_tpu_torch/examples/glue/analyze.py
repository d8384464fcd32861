"""GLUE-style text-classification influence analysis.

Port of `examples/glue/analyze.py`: the encoder classifier on padded token
sequences (the attention mask reaches every tracked module), EK-FAC factors
and pairwise scores.

    python -m kronfluence_tpu_torch.examples.glue.analyze --num_train 256
"""

import argparse

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.glue.pipeline import construct_classifier, get_sst2_dataset


def analyze(module, task, train_data, query_data, batch_size: int, output_dir: str):
    """The script's analysis of `module`: EK-FAC factors "ekfac" on
    `train_data` and pairwise scores "pairwise" of every query in one batch
    against every train example; returns the Analyzer and the scores."""
    device = next(module.parameters()).device
    analyzer = Analyzer("glue", prepare_model(module, task), task, cpu=device.type == "cpu",
                        output_dir=output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    analyzer.compute_pairwise_scores(
        "pairwise", "ekfac", query_data, train_data,
        per_device_query_batch_size=len(query_data["label"]),
        per_device_train_batch_size=batch_size,
        score_args=ScoreArguments(),
    )
    return analyzer, analyzer.load_pairwise_scores("pairwise")["all_modules"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--output_dir", default="./influence_results/glue")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    module, task = construct_classifier(device=device)
    train_data = get_sst2_dataset("train", args.num_train, seed=0)
    query_data = get_sst2_dataset("eval", args.num_query, seed=1)
    analyzer, scores = analyze(module, task, train_data, query_data, args.batch_size,
                               args.output_dir)
    print(f"pairwise scores: {tuple(scores.shape)}")
    print(analyzer.profiler.summary())
    return analyzer, scores


if __name__ == "__main__":
    main()
