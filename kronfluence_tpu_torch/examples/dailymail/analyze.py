"""CNN/DailyMail-style seq2seq influence analysis.

Port of `examples/dailymail/analyze.py`: the encoder-decoder (T5-class)
summarization task with dict attention masks (encoder modules masked and
counted by the article mask, decoder modules by the summary mask), EK-FAC
factors and pairwise scores. `train`'s checkpoint is loaded where
`--checkpoint_dir` holds one.

    python -m kronfluence_tpu_torch.examples.dailymail.analyze --num_train 128
"""

import argparse
from pathlib import Path

import torch

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.dailymail.pipeline import (
    construct_seq2seq,
    get_dailymail_dataset,
)
from kronfluence_tpu_torch.utils.save import load_file


def analyze(module, task, train_data, query_data, batch_size: int, output_dir: str):
    """The script's analysis of `module`: EK-FAC factors "ekfac" on
    `train_data` and pairwise scores "pairwise" of every query in one batch
    against every train example; returns the Analyzer and the scores."""
    device = next(module.parameters()).device
    analyzer = Analyzer("dailymail", prepare_model(module, task), task,
                        cpu=device.type == "cpu", output_dir=output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=batch_size,
        factor_args=FactorArguments(strategy="ekfac"),
    )
    analyzer.compute_pairwise_scores(
        "pairwise", "ekfac", query_data, train_data,
        per_device_query_batch_size=len(query_data["input_ids"]),
        per_device_train_batch_size=batch_size,
        score_args=ScoreArguments(),
    )
    return analyzer, analyzer.load_pairwise_scores("pairwise")["all_modules"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=8)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--checkpoint_dir", default="./checkpoints/dailymail")
    parser.add_argument("--output_dir", default="./influence_results/dailymail")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    module, task = construct_seq2seq(device=device)
    ckpt = Path(args.checkpoint_dir) / "model.safetensors"
    if ckpt.exists():
        with torch.no_grad():
            module.load_state_dict(load_file(ckpt))
        print(f"loaded checkpoint {ckpt}")

    train_data = get_dailymail_dataset("train", args.num_train, seed=0)
    query_data = get_dailymail_dataset("valid", args.num_query, seed=1)
    analyzer, scores = analyze(module, task, train_data, query_data, args.batch_size,
                               args.output_dir)
    print(f"pairwise scores: {tuple(scores.shape)}")
    top = torch.argsort(-scores.float(), dim=1)[:, :3]
    print(f"top-3 influential train examples per query:\n{top.cpu().numpy()}")
    print(analyzer.profiler.summary())
    return analyzer, scores


if __name__ == "__main__":
    main()
