"""ImageNet-style ResNet-50 influence analysis with data parallelism.

Port of `examples/imagenet/ddp_analyze.py`: the reference's DDP and
query-batching configuration on a data mesh (`parallel/`). Run under
torchrun, one process a card, it joins torchrun's group (NCCL; gloo with
`--cpu`); each rank fits and scores its `--per_device_batch_size` rows of
every global batch, the factor sums are reduced once a stage, rank 0 alone
writes the artifacts and every rank returns the whole score matrix. Without
torchrun (no `WORLD_SIZE`) it runs as one process on a mesh of one.

    torchrun --nproc_per_node 4 -m kronfluence_tpu_torch.examples.imagenet.ddp_analyze \
        --data_parallel 4 --image_size 64
"""

import argparse

import torch.distributed as dist

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.imagenet.pipeline import construct_resnet, synthetic_imagenet
from kronfluence_tpu_torch.parallel import distributed
from kronfluence_tpu_torch.parallel.mesh import make_mesh


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="mesh data-axis size (default: all processes)")
    parser.add_argument("--arch", default="resnet50", choices=["resnet50", "resnet9"],
                        help="resnet9 is the CI smoke-test size")
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--num_classes", type=int, default=100)
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--num_query", type=int, default=16)
    parser.add_argument("--per_device_batch_size", type=int, default=8)
    parser.add_argument("--query_gradient_low_rank", type=int, default=32)
    parser.add_argument("--output_dir", default="./influence_results/imagenet")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    example_device(args.cpu)
    # A group that the caller joined stays the caller's; one this call joins
    # is left before it returns.
    owns_group = not dist.is_initialized() and distributed.initialize(
        backend="gloo" if args.cpu else "nccl")
    try:
        mesh = make_mesh(data=args.data_parallel, device="cpu" if args.cpu else None)
        print(f"mesh: data {mesh.data}, rank {mesh.rank}, {mesh.backend or 'no group'}, "
              f"{mesh.device}")
        model, task = construct_resnet(args.arch, args.num_classes, seed=0, device=mesh.device)
        train_data = synthetic_imagenet(args.num_train, args.image_size, args.num_classes, 0)
        query_data = synthetic_imagenet(args.num_query, args.image_size, args.num_classes, 1)

        analyzer = Analyzer("imagenet", model, task, mesh=mesh, cpu=args.cpu,
                            output_dir=args.output_dir, profile=True)
        analyzer.fit_all_factors(
            "ekfac", train_data, per_device_batch_size=args.per_device_batch_size,
            factor_args=FactorArguments(strategy="ekfac"),
        )
        analyzer.compute_pairwise_scores(
            "pairwise_qb", "ekfac", query_data, train_data,
            per_device_query_batch_size=args.num_query,
            per_device_train_batch_size=args.per_device_batch_size,
            score_args=ScoreArguments(query_gradient_low_rank=args.query_gradient_low_rank),
        )
        scores = analyzer.load_pairwise_scores("pairwise_qb")["all_modules"]
        print(f"pairwise scores: {tuple(scores.shape)}")
        print(analyzer.profiler.summary())
        return analyzer, scores
    finally:
        if owns_group:
            distributed.shutdown()


if __name__ == "__main__":
    main()
