"""Mislabeled-example detection by self-influence.

Port of `examples/cifar/detect_mislabeled_dataset.py`: train ResNet-9 on
images with 10% of the labels corrupted, compute EK-FAC self-influence, and
report what share of the corrupted labels the top-scoring examples hold:
high self-influence flags mislabeled data.

    python -m kronfluence_tpu_torch.examples.cifar.detect_mislabeled_dataset --num_train 1024
"""

import argparse

import numpy as np

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments
from kronfluence_tpu_torch.examples.cifar.pipeline import get_cifar10_dataset, train_resnet9
from kronfluence_tpu_torch.examples.common import example_device


def recall_at(scores: np.ndarray, corrupt_idx: np.ndarray, frac: float) -> float:
    """The share of `corrupt_idx` among the top `frac` of `scores`."""
    top = set(map(int, np.argsort(scores)[::-1][: int(len(scores) * frac)]))
    corrupt = set(map(int, corrupt_idx))
    return len(top & corrupt) / len(corrupt)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=1024)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--output_dir", default="./influence_results/cifar")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data, corrupt_idx = get_cifar10_dataset("train", args.num_train, corrupt_frac=0.1)
    _, model, task = train_resnet9(
        train_data, epochs=args.epochs, batch_size=args.batch_size, device=device
    )

    analyzer = Analyzer("cifar", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    analyzer.compute_self_scores(
        "self", "ekfac", train_data, per_device_train_batch_size=args.batch_size,
        score_args=ScoreArguments(),
    )
    scores = analyzer.load_self_scores("self")["all_modules"]

    recalls = {}
    for frac in (0.1, 0.2):
        recalls[frac] = recall_at(scores.double().cpu().numpy(), corrupt_idx, frac)
        print(f"top-{int(frac * 100)}% self-influence captures "
              f"{100 * recalls[frac]:.1f}% of mislabeled examples")
    print(analyzer.profiler.summary())
    return analyzer, scores, recalls


if __name__ == "__main__":
    main()
