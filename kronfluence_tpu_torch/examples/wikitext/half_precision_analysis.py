"""bf16 against fp32 score fidelity.

Port of `examples/wikitext/half_precision_analysis.py`: both recipes' pairwise
scores on the same model and data, and their Pearson and mean per-query
Spearman correlations (the reference publishes 0.96 for bf16 over 481
queries). `--fp8_storage` also scores with the bf16 recipe's float8 query
blocks, reusing its factors.

    python -m kronfluence_tpu_torch.examples.wikitext.half_precision_analysis --num_train 128 --num_query 16
"""

import argparse

import numpy as np

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.wikitext.pipeline import (
    LanguageModelingTask,
    construct_gpt2,
    get_wikitext_dataset,
)
from kronfluence_tpu_torch.utils.common.factor_arguments import (
    all_low_precision_factor_arguments,
)
from kronfluence_tpu_torch.utils.common.score_arguments import (
    all_low_precision_score_arguments,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_layers", type=int, default=4)
    parser.add_argument("--d_model", type=int, default=256)
    parser.add_argument("--num_heads", type=int, default=4)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--vocab", type=int, default=8192)
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--train_batch_size", type=int, default=16)
    parser.add_argument("--fp8_storage", action="store_true",
                        help="also certify the float8 query-block storage recipe")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    parser.add_argument("--output_dir", default="./influence_results/wikitext_hp")
    return parser.parse_args(argv)


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-query Spearman rank correlation."""
    def rank(v):
        order = np.argsort(v)
        r = np.empty_like(order, dtype=np.float64)
        r[order] = np.arange(len(v))
        return r

    return float(np.mean([np.corrcoef(rank(a[q]), rank(b[q]))[0, 1] for q in range(a.shape[0])]))


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args.cpu)
    module = construct_gpt2(args.num_layers, args.d_model, args.num_heads, args.seq_len,
                            args.vocab, device=device)
    task = LanguageModelingTask(args.num_layers)
    model = prepare_model(module, task)
    train = get_wikitext_dataset("train", args.num_train, args.seq_len, args.vocab)
    query = get_wikitext_dataset("validation", args.num_query, args.seq_len, args.vocab)

    analyzer = Analyzer("wikitext_hp", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, disable_tqdm=True)
    recipes = {
        "fp32": (FactorArguments(strategy="ekfac"), ScoreArguments()),
        "bf16": (
            all_low_precision_factor_arguments(strategy="ekfac"),
            all_low_precision_score_arguments(),
        ),
    }
    if args.fp8_storage:
        # The bf16 recipe with float8 storage of the resident query block:
        # its factor arguments are the bf16 recipe's, so those factors are
        # reused (None) and only the score pass differs.
        sa8 = all_low_precision_score_arguments()
        sa8.query_gradient_storage_dtype = "float8_e4m3fn"
        recipes["bf16+fp8qs"] = (None, sa8)
    scores = {}
    for name, (fa, sa) in recipes.items():
        factors_name = f"ekfac_{name}" if fa is not None else "ekfac_bf16"
        if fa is not None:
            analyzer.fit_all_factors(
                factors_name, train, per_device_batch_size=args.train_batch_size,
                factor_args=fa, overwrite_output_dir=True,
            )
        analyzer.compute_pairwise_scores(
            f"pairwise_{name}", factors_name, query, train,
            per_device_query_batch_size=args.num_query,
            per_device_train_batch_size=args.train_batch_size,
            score_args=sa, overwrite_output_dir=True,
        )
        scores[name] = (analyzer.load_pairwise_scores(f"pairwise_{name}")["all_modules"]
                        .double().cpu().numpy())
        analyzer.release_memory()

    a = scores["fp32"]
    results = {}
    for name, b in scores.items():
        if name == "fp32":
            continue
        pearson = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
        rho = spearman(a, b)
        results[name] = (pearson, rho)
        print(f"\nfp32 vs {name} pairwise scores over {a.shape[0]} queries x {a.shape[1]} train:")
        print(f"  Pearson  (flattened): {pearson:.4f}")
        print(f"  Spearman (per-query mean): {rho:.4f}")
    print("  reference published (bf16): 0.96")
    return results


if __name__ == "__main__":
    main()
