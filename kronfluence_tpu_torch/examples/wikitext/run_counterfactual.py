"""Counterfactual retraining for the LM: remove the top-influence sequences.

Port of `examples/wikitext/run_counterfactual.py`: remove the k training
sequences with the largest summed influence on the queries, retrain, and
compare the queries' per-token cross-entropy with removing k random
sequences.

    python -m kronfluence_tpu_torch.examples.wikitext.run_counterfactual --num_train 128 --remove 16
"""

import argparse

import numpy as np
import torch

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device, train_model
from kronfluence_tpu_torch.examples.wikitext.pipeline import (
    LanguageModelingTask,
    construct_gpt2,
    get_wikitext_dataset,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--d_model", type=int, default=128)
    parser.add_argument("--num_heads", type=int, default=2)
    parser.add_argument("--seq_len", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=1024)
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=8)
    parser.add_argument("--remove", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=6)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seeds", type=int, default=2)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    parser.add_argument("--output_dir", default="./influence_results/wikitext_cf")
    return parser.parse_args(argv)


def train_lm(task, model, data, args, seed):
    def loss_fn(m, batch, generator):
        n_tok = batch["attention_mask"][:, 1:].sum().clamp_min(1)
        return task.compute_train_loss(batch, m) / n_tok

    return train_model(loss_fn, model, data, batch_size=args.batch_size,
                       num_epochs=args.epochs, seed=seed, learning_rate=3e-4)


@torch.no_grad()
def query_loss_per_token(task, model, query) -> float:
    device = next(model.parameters()).device
    batch = {k: torch.as_tensor(v, device=device) for k, v in query.items()}
    total = task.compute_train_loss(batch, model)
    return float(total) / float(batch["attention_mask"][:, 1:].sum())


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args.cpu)
    task = LanguageModelingTask(args.num_layers)
    train = get_wikitext_dataset("train", args.num_train, args.seq_len, args.vocab)
    query = get_wikitext_dataset("validation", args.num_query, args.seq_len, args.vocab)

    def build(seed):
        return construct_gpt2(args.num_layers, args.d_model, args.num_heads, args.seq_len,
                              args.vocab, seed=seed, device=device)

    model = train_lm(task, build(0), train, args, seed=0)
    analyzer = Analyzer("wikitext_cf", prepare_model(model, task), task,
                        cpu=device.type == "cpu", output_dir=args.output_dir, disable_tqdm=True)
    analyzer.fit_all_factors(
        "ekfac", train, per_device_batch_size=args.batch_size,
        factor_args=FactorArguments(strategy="ekfac"), overwrite_output_dir=True,
    )
    analyzer.compute_pairwise_scores(
        "cf", "ekfac", query, train,
        per_device_query_batch_size=args.num_query,
        per_device_train_batch_size=args.batch_size,
        score_args=ScoreArguments(), overwrite_output_dir=True,
    )
    scores = analyzer.load_pairwise_scores("cf")["all_modules"].double().cpu().numpy()
    total = scores.sum(axis=0)
    most_positive = np.argsort(total)[::-1][: args.remove]
    all_idx = np.arange(args.num_train)
    rng = np.random.default_rng(0)

    results = {}
    for name in ("full dataset", "remove most-positive", "remove random"):
        losses = []
        for seed in range(args.seeds):
            if name == "full dataset":
                keep = all_idx
            elif name == "remove most-positive":
                keep = np.setdiff1d(all_idx, most_positive)
            else:
                keep = np.setdiff1d(all_idx, rng.choice(all_idx, size=args.remove, replace=False))
            sub = {k: v[keep] for k, v in train.items()}
            trained = train_lm(task, build(seed), sub, args, seed)
            losses.append(query_loss_per_token(task, trained, query))
        results[name] = (float(np.mean(losses)), float(np.std(losses)))
        print(f"  {name:<24} query CE/token {results[name][0]:.4f} +- {results[name][1]:.4f}")

    base = results["full dataset"][0]
    pos = results["remove most-positive"][0]
    rand = results["remove random"][0]
    print(f"\nremoving most-positive changed CE by {pos - base:+.4f} vs random {rand - base:+.4f}")
    return results


if __name__ == "__main__":
    main()
