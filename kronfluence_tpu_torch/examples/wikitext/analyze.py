"""WikiText-style language-model influence analysis.

Port of `examples/wikitext/analyze.py`: a GPT-2-class LM, EK-FAC factors and
pairwise scores, optionally per token and with the all-low-precision (bf16)
recipe, on synthetic token streams.

    python -m kronfluence_tpu_torch.examples.wikitext.analyze --num_layers 4 --d_model 256 --seq_len 128
"""

import argparse

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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_layers", type=int, default=4)
    parser.add_argument("--d_model", type=int, default=256)
    parser.add_argument("--num_heads", type=int, default=4)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--vocab", type=int, default=8192)
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--train_batch_size", type=int, default=16)
    parser.add_argument("--per_token", action="store_true")
    parser.add_argument("--low_precision", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    parser.add_argument("--output_dir", default="./influence_results/wikitext")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    module = construct_gpt2(
        args.num_layers, args.d_model, args.num_heads, args.seq_len, args.vocab, device=device,
    )
    task = LanguageModelingTask(args.num_layers)
    model = prepare_model(module, task)
    train_data = get_wikitext_dataset("train", args.num_train, args.seq_len, args.vocab)
    query_data = get_wikitext_dataset("validation", args.num_query, args.seq_len, args.vocab)

    if args.low_precision:
        factor_args = all_low_precision_factor_arguments(strategy="ekfac")
        score_args = all_low_precision_score_arguments()
    else:
        factor_args = FactorArguments(strategy="ekfac")
        score_args = ScoreArguments()
    score_args.compute_per_token_scores = args.per_token

    analyzer = Analyzer("wikitext", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.train_batch_size,
        factor_args=factor_args,
    )
    analyzer.compute_pairwise_scores(
        "pairwise", "ekfac", query_data, train_data,
        per_device_query_batch_size=args.num_query,
        per_device_train_batch_size=args.train_batch_size,
        score_args=score_args,
    )
    scores = analyzer.load_pairwise_scores("pairwise")["all_modules"]
    print(f"pairwise scores: {tuple(scores.shape)}")
    print(analyzer.profiler.summary())
    return analyzer, scores


if __name__ == "__main__":
    main()
