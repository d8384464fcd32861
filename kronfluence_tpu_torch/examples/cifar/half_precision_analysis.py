"""bf16 against fp32 self-influence fidelity on CIFAR.

Port of `examples/cifar/half_precision_analysis.py`: self-influence twice,
full fp32 and the bf16 recipe (`all_low_precision_factor_arguments`), and
their Pearson and Spearman correlations and the top-10% overlap that the
mislabel-detection workflow consumes.

    python -m kronfluence_tpu_torch.examples.cifar.half_precision_analysis --num_train 512
"""

import argparse

import numpy as np

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments
from kronfluence_tpu_torch.evaluate import spearman_correlation
from kronfluence_tpu_torch.examples.cifar.pipeline import get_cifar10_dataset, train_resnet9
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.utils.common.factor_arguments import (
    all_low_precision_factor_arguments,
)
from kronfluence_tpu_torch.utils.common.score_arguments import (
    all_low_precision_score_arguments,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--output_dir", default="./influence_results/cifar_half")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data, _ = get_cifar10_dataset("train", args.num_train, corrupt_frac=0.1)
    _, model, task = train_resnet9(
        train_data, epochs=args.epochs, batch_size=args.batch_size, verbose=False, device=device
    )
    analyzer = Analyzer("cifar_half", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir)

    def run(tag, factor_args, score_args):
        analyzer.fit_all_factors(
            tag, train_data, per_device_batch_size=args.batch_size, factor_args=factor_args,
        )
        analyzer.compute_self_scores(
            tag, tag, train_data, per_device_train_batch_size=args.batch_size,
            score_args=score_args,
        )
        return analyzer.load_self_scores(tag)["all_modules"].double().cpu().numpy()

    fp32 = run("fp32", FactorArguments(strategy="ekfac"), ScoreArguments())
    bf16 = run(
        "bf16",
        all_low_precision_factor_arguments(strategy="ekfac", dtype="bfloat16"),
        all_low_precision_score_arguments(dtype="bfloat16"),
    )

    pearson = float(np.corrcoef(fp32, bf16)[0, 1])
    spearman = float(spearman_correlation(fp32, bf16)[0])
    k = max(1, len(fp32) // 10)
    top_fp32 = set(np.argsort(fp32)[::-1][:k].tolist())
    top_bf16 = set(np.argsort(bf16)[::-1][:k].tolist())
    overlap = len(top_fp32 & top_bf16) / k
    print(f"self-influence bf16 vs fp32: pearson={pearson:.4f} "
          f"spearman={spearman:.4f} top-10% overlap={overlap:.3f}")
    return {"pearson": pearson, "spearman": spearman, "top10_overlap": overlap}


if __name__ == "__main__":
    main()
