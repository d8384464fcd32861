"""Counterfactual retraining for GLUE: remove the top-influence training
examples and measure the query loss.

Port of `examples/glue/run_counterfactual.py`: drop the k training examples
with the largest summed pairwise score on the queries, retrain from the same
initial weights, and compare the mean query loss with dropping k random
examples. Influence-guided removal should hurt the queries more.

    python -m kronfluence_tpu_torch.examples.glue.run_counterfactual --num_train 256 --remove 32
"""

import argparse
import copy

import numpy as np
import torch

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device, train_model
from kronfluence_tpu_torch.examples.glue.pipeline import construct_classifier, get_sst2_dataset


def train_classifier(task, init, data, args, seed):
    """A copy of `init` trained on `data` (AdamW on the mean cross-entropy)."""
    return train_model(
        lambda m, b, g: task.compute_train_loss(b, m) / len(b["label"]),
        copy.deepcopy(init), data, batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=3e-4, seed=seed,
    )


@torch.no_grad()
def query_loss(task, module, query) -> float:
    """The queries' mean cross-entropy."""
    device = next(module.parameters()).device
    batch = {k: torch.as_tensor(v, device=device) for k, v in query.items()}
    return float(task.compute_train_loss(batch, module)) / len(query["label"])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--remove", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--seeds", type=int, default=2)
    parser.add_argument("--output_dir", default="./influence_results/glue_cf")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data = get_sst2_dataset("train", args.num_train)
    query_data = get_sst2_dataset("eval", args.num_query, seed=1)
    init, task = construct_classifier(device=device)
    module = train_classifier(task, init, train_data, args, seed=0)

    analyzer = Analyzer("glue_cf", prepare_model(module, task), task,
                        cpu=device.type == "cpu", output_dir=args.output_dir)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    analyzer.compute_pairwise_scores(
        "cf", "ekfac", query_data, train_data,
        per_device_query_batch_size=args.num_query,
        per_device_train_batch_size=args.batch_size,
        score_args=ScoreArguments(),
    )
    scores = analyzer.load_pairwise_scores("cf")["all_modules"].double().cpu().numpy()
    top_idx = np.argsort(scores.sum(axis=0))[::-1][: args.remove]

    def retrain_without(drop_idx, seed):
        keep = np.setdiff1d(np.arange(args.num_train), drop_idx)
        sub = {k: v[keep] for k, v in train_data.items()}
        return query_loss(task, train_classifier(task, init, sub, args, seed), query_data)

    base = float(np.mean([
        query_loss(task, train_classifier(task, init, train_data, args, seed=s), query_data)
        for s in range(args.seeds)
    ]))
    infl = float(np.mean([retrain_without(top_idx, seed=s) for s in range(args.seeds)]))
    rng = np.random.default_rng(0)
    rand = float(np.mean([
        retrain_without(rng.choice(args.num_train, args.remove, replace=False), seed=s)
        for s in range(args.seeds)
    ]))

    print(f"query loss — full train set:         {base:.4f}")
    print(f"query loss — remove {args.remove} random:     {rand:.4f}")
    print(f"query loss — remove {args.remove} top-influence: {infl:.4f}")
    print(f"influence removal hurts {infl - rand:+.4f} more than random")
    return {"full": base, "random": rand, "top-influence": infl}


if __name__ == "__main__":
    main()
