"""Per-token influence attribution.

Port of `examples/wikitext/tokenwise_analysis.py`: pairwise scores with
`compute_per_token_scores=True`, which train tokens drive a query's
influence, and the check that the token scores sum to the sequence scores.

    python -m kronfluence_tpu_torch.examples.wikitext.tokenwise_analysis --num_train 64 --num_query 4
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


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--d_model", type=int, default=128)
    parser.add_argument("--num_heads", type=int, default=2)
    parser.add_argument("--seq_len", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=1024)
    parser.add_argument("--num_train", type=int, default=64)
    parser.add_argument("--num_query", type=int, default=4)
    parser.add_argument("--train_batch_size", type=int, default=16)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    parser.add_argument("--output_dir", default="./influence_results/wikitext_tok")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args.cpu)
    module = construct_gpt2(args.num_layers, args.d_model, args.num_heads, args.seq_len,
                            args.vocab, device=device)
    task = LanguageModelingTask(args.num_layers)
    model = prepare_model(module, task)
    train = get_wikitext_dataset("train", args.num_train, args.seq_len, args.vocab)
    query = get_wikitext_dataset("validation", args.num_query, args.seq_len, args.vocab)

    analyzer = Analyzer("wikitext_tok", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, disable_tqdm=True)
    analyzer.fit_all_factors(
        "ekfac", train, per_device_batch_size=args.train_batch_size,
        factor_args=FactorArguments(strategy="ekfac"), overwrite_output_dir=True,
    )
    for name, per_token in (("seq", False), ("tok", True)):
        analyzer.compute_pairwise_scores(
            name, "ekfac", query, train,
            per_device_query_batch_size=args.num_query,
            per_device_train_batch_size=args.train_batch_size,
            score_args=ScoreArguments(compute_per_token_scores=per_token),
            overwrite_output_dir=True,
        )
    seq = analyzer.load_pairwise_scores("seq")["all_modules"].double().cpu().numpy()
    tok = analyzer.load_pairwise_scores("tok")["all_modules"].double().cpu().numpy()
    print(f"sequence scores {seq.shape}, per-token scores {tok.shape}")

    # Invariance: summing token scores recovers sequence scores.
    delta = np.abs(tok.sum(axis=-1) - seq).max() / (np.abs(seq).max() + 1e-12)
    print(f"max |sum(token) - sequence| / max|sequence| = {delta:.2e}")

    # The most influential train tokens for query 0.
    q = 0
    top_train = int(np.argmax(seq[q]))
    row = tok[q, top_train]
    top_tokens = np.argsort(row)[::-1][:8]
    print(f"query {q}: most influential train seq {top_train}; top token positions "
          f"{top_tokens.tolist()} (scores {np.round(row[top_tokens], 3)})")
    return seq, tok, delta


if __name__ == "__main__":
    main()
