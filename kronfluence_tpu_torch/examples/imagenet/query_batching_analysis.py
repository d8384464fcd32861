"""Low-rank query batching's fidelity: full-rank against rank-32 scores.

Port of `examples/imagenet/query_batching_analysis.py`: pairwise scores with
full-rank query gradients and with `query_gradient_low_rank=32`, and their
averaged per-query Spearman and Pearson correlations (the reference reports
the rank-32 approximation keeping the ordering above 0.9). The reference's
plots are printed correlations here.

    python -m kronfluence_tpu_torch.examples.imagenet.query_batching_analysis --num_train 128
"""

import argparse

import numpy as np

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments
from kronfluence_tpu_torch.evaluate import spearman_correlation
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.imagenet.pipeline import (
    construct_resnet,
    get_imagenet_dataset,
)


def _rank_correlations(a: np.ndarray, b: np.ndarray):
    """Per-query Spearman and Pearson correlations, averaged."""
    pearson = [np.corrcoef(a[q], b[q])[0, 1] for q in range(a.shape[0])]
    return float(np.mean(spearman_correlation(a, b))), float(np.mean(pearson))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="resnet9", choices=["resnet50", "resnet9"])
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=8)
    parser.add_argument("--per_device_batch_size", type=int, default=16)
    parser.add_argument("--query_gradient_low_rank", type=int, default=32)
    parser.add_argument("--output_dir", default="./influence_results/imagenet")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    model, task = construct_resnet(args.arch, args.num_classes, device=device)
    train_data = get_imagenet_dataset(
        "train", args.num_train, args.image_size, args.num_classes, 0
    )
    query_data = get_imagenet_dataset(
        "valid", args.num_query, args.image_size, args.num_classes, 1
    )

    analyzer = Analyzer("imagenet_qb", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.per_device_batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    common = dict(
        per_device_query_batch_size=args.num_query,
        per_device_train_batch_size=args.per_device_batch_size,
    )
    rank = args.query_gradient_low_rank
    analyzer.compute_pairwise_scores(
        "full_rank", "ekfac", query_data, train_data, score_args=ScoreArguments(), **common,
    )
    analyzer.compute_pairwise_scores(
        f"qlr{rank}", "ekfac", query_data, train_data,
        score_args=ScoreArguments(query_gradient_low_rank=rank), **common,
    )
    full = analyzer.load_pairwise_scores("full_rank")["all_modules"].double().cpu().numpy()
    low = analyzer.load_pairwise_scores(f"qlr{rank}")["all_modules"].double().cpu().numpy()
    spearman, pearson = _rank_correlations(full, low)
    print(f"averaged Spearman correlation (full vs rank-{rank}): {spearman:.4f}")
    print(f"averaged Pearson  correlation (full vs rank-{rank}): {pearson:.4f}")
    return spearman, pearson


if __name__ == "__main__":
    main()
