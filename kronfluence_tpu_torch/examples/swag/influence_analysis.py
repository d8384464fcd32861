"""The most and least influential SWAG training examples a query.

Port of `examples/swag/influence_analysis.py`. The data is synthetic, so
there is no text to print: each of the first three queries' top and bottom
training examples by pairwise score (rank-`--query_gradient_low_rank` query
gradients), their labels, and the top ones' label agreement with the query.
In `analyze`'s output directory it finds `analyze`'s factors ("ekfac" of the
Analyzer "swag") and scores against them.

    python -m kronfluence_tpu_torch.examples.swag.influence_analysis --num_train 128
"""

import argparse

import numpy as np

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.swag.pipeline import construct_choice_model, get_swag_dataset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=8)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--query_gradient_low_rank", type=int, default=16)
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--output_dir", default="./influence_results/swag")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    module, task = construct_choice_model(device=device)
    train_data = get_swag_dataset("train", args.num_train, seed=0)
    query_data = get_swag_dataset("eval", args.num_query, seed=1)

    analyzer = Analyzer("swag", prepare_model(module, task), task, cpu=device.type == "cpu",
                        output_dir=args.output_dir)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    analyzer.compute_pairwise_scores(
        "analysis", "ekfac", query_data, train_data,
        per_device_query_batch_size=args.num_query,
        per_device_train_batch_size=args.batch_size,
        score_args=ScoreArguments(query_gradient_low_rank=args.query_gradient_low_rank),
    )
    scores = analyzer.load_pairwise_scores("analysis")["all_modules"].double().cpu().numpy()

    agreement = {}
    for q in range(min(args.num_query, 3)):
        order = np.argsort(scores[q])[::-1]
        top, bottom = order[: args.top_k], order[-args.top_k :]
        q_label = int(query_data["label"][q])
        print(f"query {q} (label {q_label}):")
        for tag, idxs in (("top", top), ("bottom", bottom)):
            rows = ", ".join(
                f"#{int(i)} (score {scores[q, i]:+.3e}, label {int(train_data['label'][i])})"
                for i in idxs
            )
            print(f"  {tag:6s}: {rows}")
        agreement[q] = float(np.mean(train_data["label"][top] == q_label))
        print(f"  top-{args.top_k} label agreement with query: {agreement[q]:.2f}")
    return scores, agreement


if __name__ == "__main__":
    main()
