"""Counterfactual retraining: do influence scores predict loss changes?

Port of `examples/uci/run_counterfactual.py`: remove the k training examples
with the most positive, the most negative or random summed influence on the
queries, retrain from scratch and compare the queries' mean squared error.
If EK-FAC influence is faithful, removing the positive ones raises the query
loss more than removing random ones, and removing the negative ones lowers it.

    python -m kronfluence_tpu_torch.examples.uci.run_counterfactual --num_train 256 --remove 20
"""

import argparse

import numpy as np
import torch

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device, train_model
from kronfluence_tpu_torch.examples.uci.pipeline import (
    RegressionTask,
    construct_regression_mlp,
    get_regression_dataset,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--queries", type=int, default=8)
    parser.add_argument("--remove", type=int, default=20)
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--seeds", type=int, default=3, help="retrain seeds to average")
    parser.add_argument("--output_dir", default="./influence_results/uci_counterfactual")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    return parser.parse_args(argv)


def train(task, data, epochs, batch_size, seed, device):
    """A model trained from scratch on `data` from `seed`."""
    model = construct_regression_mlp(seed=seed, device=device)
    return train_model(lambda m, b, g: task.compute_train_loss(b, m) / len(b["y"]),
                       model, data, batch_size=min(batch_size, len(data["y"])),
                       num_epochs=epochs, seed=seed)


@torch.no_grad()
def query_loss(task, model, query_data) -> float:
    """The queries' mean squared error."""
    device = next(model.parameters()).device
    batch = {k: torch.as_tensor(v, device=device) for k, v in query_data.items()}
    return float(task.compute_measurement(batch, model)) / len(query_data["y"])


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args.cpu)
    train_data = get_regression_dataset("train", args.num_train, seed=0)
    query_data = get_regression_dataset("eval", args.queries, seed=0)
    task = RegressionTask()

    # Train the analysis model and compute influence scores.
    model = train(task, train_data, args.epochs, args.batch_size, 0, device)
    analyzer = Analyzer("uci_cf", prepare_model(model, task), task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, disable_tqdm=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.batch_size,
        factor_args=FactorArguments(strategy="ekfac", use_empirical_fisher=True),
        overwrite_output_dir=True,
    )
    analyzer.compute_pairwise_scores(
        "cf", "ekfac", query_data, train_data,
        per_device_query_batch_size=args.queries,
        per_device_train_batch_size=args.batch_size,
        score_args=ScoreArguments(), overwrite_output_dir=True,
    )
    scores = analyzer.load_pairwise_scores("cf")["all_modules"].double().cpu().numpy()
    # Positive pairwise score = removing the example INCREASES query loss.
    total = scores.sum(axis=0)
    order = np.argsort(total)
    most_negative = order[: args.remove]
    most_positive = order[::-1][: args.remove]
    rng = np.random.default_rng(0)

    all_idx = np.arange(args.num_train)
    conditions = {
        "full dataset": all_idx,
        "remove most-positive": np.setdiff1d(all_idx, most_positive),
        "remove most-negative": np.setdiff1d(all_idx, most_negative),
        "remove random": None,  # drawn anew for each seed
    }
    print(f"\nCounterfactual retraining ({args.seeds} seeds, removing {args.remove}):")
    results = {}
    for name, keep in conditions.items():
        losses = []
        for seed in range(args.seeds):
            if keep is None:
                drop = rng.choice(all_idx, size=args.remove, replace=False)
                keep_s = np.setdiff1d(all_idx, drop)
            else:
                keep_s = keep
            subset = {k: v[keep_s] for k, v in train_data.items()}
            retrained = train(task, subset, args.epochs, args.batch_size, seed, device)
            losses.append(query_loss(task, retrained, query_data))
        results[name] = (float(np.mean(losses)), float(np.std(losses)))
        print(f"  {name:<24} query loss {results[name][0]:.4f} +- {results[name][1]:.4f}")

    base = results["full dataset"][0]
    pos = results["remove most-positive"][0]
    rand = results["remove random"][0]
    print(
        f"\nremoving most-positive raised loss by {pos - base:+.4f} "
        f"vs random {rand - base:+.4f} -> influence is "
        f"{'predictive' if pos - base > rand - base else 'NOT predictive'}"
    )
    return results


if __name__ == "__main__":
    main()
