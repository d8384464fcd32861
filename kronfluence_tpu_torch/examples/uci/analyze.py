"""UCI regression influence analysis: the minimal end-to-end workflow.

Port of `examples/uci/analyze.py`: train the MLP on Concrete (the synthetic
mirror unless `UCI_CONCRETE_CSV` names a local CSV), fit EK-FAC factors on the
empirical Fisher and compute pairwise scores.

    python -m kronfluence_tpu_torch.examples.uci.analyze --num_train 512 --queries 16
"""

import argparse

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import (
    example_device,
    print_top_influences,
    train_model,
)
from kronfluence_tpu_torch.examples.uci.pipeline import (
    RegressionTask,
    construct_regression_mlp,
    get_regression_dataset,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=512)
    parser.add_argument("--queries", type=int, default=16)
    parser.add_argument("--train_batch_size", type=int, default=64)
    parser.add_argument("--output_dir", default="./influence_results/uci")
    parser.add_argument("--strategy", default="ekfac")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data = get_regression_dataset("train", args.num_train)
    query_data = get_regression_dataset("eval", args.queries)
    task = RegressionTask()
    module = construct_regression_mlp(device=device)
    train_model(lambda m, b, g: task.compute_train_loss(b, m) / len(b["y"]),
                module, train_data, num_epochs=10)
    model = prepare_model(module, task)

    analyzer = Analyzer("uci", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.train_batch_size,
        factor_args=FactorArguments(strategy=args.strategy, use_empirical_fisher=True),
    )
    analyzer.compute_pairwise_scores(
        "pairwise", "ekfac", query_data, train_data,
        per_device_query_batch_size=args.queries,
        per_device_train_batch_size=args.train_batch_size,
        score_args=ScoreArguments(),
    )
    scores = analyzer.load_pairwise_scores("pairwise")["all_modules"]
    print(f"pairwise scores: {tuple(scores.shape)}")
    print_top_influences(scores)
    print(analyzer.profiler.summary())
    return analyzer, scores


if __name__ == "__main__":
    main()
