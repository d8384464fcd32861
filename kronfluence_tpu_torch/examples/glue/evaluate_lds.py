"""Linear datamodeling score (LDS) of the GLUE-style example.

Port of `examples/glue/evaluate_lds.py`: retrain the classifier on random
train subsets and rank-correlate the measured query margins (minus each
query's loss) with the subset-summed pairwise scores, for each strategy,
through the port's `evaluate.py`. The retrains do not depend on the scores:
they run once and serve every strategy.

    python -m kronfluence_tpu_torch.examples.glue.evaluate_lds --num_train 128 --num_subsets 32
"""

import argparse
import copy

import numpy as np
import torch

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.evaluate import (
    collect_subset_measurements,
    evaluate_lds,
    sample_subset_masks,
)
from kronfluence_tpu_torch.examples.common import example_device, train_model
from kronfluence_tpu_torch.examples.glue.pipeline import construct_classifier, synthetic_sst2


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--num_subsets", type=int, default=32)
    parser.add_argument("--subset_fraction", type=float, default=0.5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--output_dir", default="./influence_results/glue_lds")
    parser.add_argument("--strategies", nargs="+", default=["ekfac", "identity"])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data = synthetic_sst2(args.num_train, seed=0)
    query_data = synthetic_sst2(args.num_query, seed=1)
    base, task = construct_classifier(device=device)

    def train_on(data):
        return train_model(lambda m, b, g: task.compute_train_loss(b, m), copy.deepcopy(base),
                           data, batch_size=args.batch_size, num_epochs=args.epochs, seed=0)

    model_full = train_on(train_data)

    def train_fn(idx, seed):
        # A fixed seed: the subset is the treatment.
        return train_on({k: v[idx] for k, v in train_data.items()})

    @torch.no_grad()
    def measure_fn(module):
        losses = []
        for i in range(args.num_query):
            batch = {k: torch.as_tensor(v[i : i + 1], device=device)
                     for k, v in query_data.items()}
            losses.append(float(task.compute_train_loss(batch, module)))
        return -np.asarray(losses)

    masks = sample_subset_masks(args.num_train, args.num_subsets, args.subset_fraction, seed=3)
    measurements = collect_subset_measurements(train_fn, measure_fn, masks, seed=3)
    results = {}
    for strategy in args.strategies:
        analyzer = Analyzer(f"glue_lds_{strategy}", prepare_model(model_full, task), task,
                            cpu=device.type == "cpu", output_dir=args.output_dir)
        analyzer.fit_all_factors(
            "factors", train_data, per_device_batch_size=args.batch_size,
            factor_args=FactorArguments(strategy=strategy, use_empirical_fisher=True),
        )
        analyzer.compute_pairwise_scores(
            "scores", "factors", query_data, train_data,
            per_device_query_batch_size=args.num_query,
            per_device_train_batch_size=args.batch_size,
            score_args=ScoreArguments(),
        )
        scores = analyzer.load_pairwise_scores("scores")["all_modules"]
        lds, per_query = evaluate_lds(scores, train_fn, measure_fn, args.num_train, masks=masks,
                                      measurements=measurements)
        results[strategy] = lds
        print(f"LDS[{strategy}] = {lds:.4f} (per-query mean of {len(per_query)})")
    return results


if __name__ == "__main__":
    main()
