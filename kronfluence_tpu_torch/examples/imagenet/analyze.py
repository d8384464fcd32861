"""Single-device ImageNet-style ResNet-50 influence analysis.

Port of `examples/imagenet/analyze.py`, the one-process twin of
`ddp_analyze.py`: an EK-FAC factor fit and pairwise scores with rank-32 query
blocks (query batching).

    python -m kronfluence_tpu_torch.examples.imagenet.analyze --arch resnet9 --image_size 32
"""

import argparse

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.imagenet.pipeline import construct_resnet, synthetic_imagenet


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="resnet50", choices=["resnet50", "resnet9"],
                        help="resnet9 is the CI smoke-test size")
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--num_classes", type=int, default=100)
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--query_batch_size", type=int, default=16)
    parser.add_argument("--query_gradient_low_rank", type=int, default=32,
                        help="None disables query batching (pass 0)")
    parser.add_argument("--output_dir", default="./influence_results/imagenet")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    model, task = construct_resnet(args.arch, args.num_classes, seed=0, device=device)
    train_data = synthetic_imagenet(args.num_train, args.image_size, args.num_classes, 0)
    query_data = synthetic_imagenet(args.num_query, args.image_size, args.num_classes, 1)

    analyzer = Analyzer("imagenet", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.train_batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    analyzer.compute_pairwise_scores(
        "pairwise", "ekfac", query_data, train_data,
        per_device_query_batch_size=args.query_batch_size,
        per_device_train_batch_size=args.train_batch_size,
        score_args=ScoreArguments(query_gradient_low_rank=args.query_gradient_low_rank or None),
    )
    scores = analyzer.load_pairwise_scores("pairwise")["all_modules"]
    print(f"pairwise scores: {tuple(scores.shape)}")
    print(analyzer.profiler.summary())
    return analyzer, scores


if __name__ == "__main__":
    main()
