"""Pairwise scoring for the large-LM recipe: low-rank query batching.

Port of `examples/openwebtext/compute_scores.py`: loads the factors
fit_factors fitted and computes pairwise scores for a set of query prompts
with rank-64 query-gradient batching, bf16 and aggregated per-query saving,
on the same model and data mesh.

    python -m kronfluence_tpu_torch.examples.openwebtext.compute_scores --num_layers 4 --d_model 512
"""

import argparse
from pathlib import Path

import numpy as np

from kronfluence_tpu_torch import Analyzer, prepare_model
from kronfluence_tpu_torch.examples.common import example_device, synthetic_tokens
from kronfluence_tpu_torch.examples.openwebtext.fit_factors import (
    add_model_arguments,
    construct_model,
)
from kronfluence_tpu_torch.parallel.mesh import make_mesh
from kronfluence_tpu_torch.utils.common.score_arguments import (
    extreme_reduce_memory_score_arguments,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_model_arguments(parser)
    parser.add_argument("--num_query", type=int, default=8)
    parser.add_argument("--per_device_query_batch_size", type=int, default=4)
    parser.add_argument("--query_gradient_low_rank", type=int, default=64)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args.cpu)
    mesh = make_mesh(model=args.model_parallel, device=device)
    module, task = construct_model(args, device)
    model = prepare_model(module, task)
    train_data = synthetic_tokens(args.num_train, args.seq_len, args.vocab, seed=0)
    query_data = synthetic_tokens(args.num_query, args.seq_len, args.vocab, seed=1)

    # The reference recipe: rank-64 query batching, bf16, accumulation.
    score_args = extreme_reduce_memory_score_arguments(
        query_gradient_low_rank=args.query_gradient_low_rank
    )
    # The recipe's 4 module partitions, at most one a tracked module: the JAX
    # example leaves a partition empty below 4 tracked modules (a one-layer
    # Llama tracks 3) and its scoring then finds no tracked module.
    score_args.module_partitions = min(
        score_args.module_partitions, len(task.get_influence_tracked_modules())
    )

    analyzer = Analyzer("openwebtext", model, task, mesh=mesh,
                        output_dir=args.output_dir, profile=True)
    if not Path(analyzer.factors_output_dir("ekfac")).exists():
        raise SystemExit(
            "Factors not found: run kronfluence_tpu_torch.examples.openwebtext.fit_factors "
            "first with the same --output_dir."
        )
    analyzer.compute_pairwise_scores(
        "prompt_scores", "ekfac", query_data, train_data,
        per_device_query_batch_size=min(args.num_query, args.per_device_query_batch_size),
        per_device_train_batch_size=args.per_device_batch_size,
        score_args=score_args,
    )
    scores = analyzer.load_pairwise_scores("prompt_scores")["all_modules"]
    print(f"pairwise scores: {tuple(scores.shape)}")
    host = scores.double().cpu().numpy()
    for q in range(min(3, host.shape[0])):
        top = np.argsort(host[q])[::-1][:5]
        print(f"  query {q}: top train sequences {top.tolist()}")
    print(analyzer.profiler.summary())
    return scores


if __name__ == "__main__":
    main()
