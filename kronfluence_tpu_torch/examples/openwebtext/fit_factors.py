"""OpenWebText/Llama-style large-LM factor fitting.

Port of `examples/openwebtext/fit_factors.py`, the reference's largest
workload: MLP-only tracked modules, bf16, the extreme-reduce-memory factor
arguments with module and data partitions, fp32 "jacobi" eigendecomposition
(factors of dimension >= LARGE_EIGH_DIM go through the host-loop Jacobi one
matrix at a time), partitioned artifacts on disk. The batch runs on a data
mesh of this process; the model axis (`--model_parallel` > 1) is not ported
and raises.

    python -m kronfluence_tpu_torch.examples.openwebtext.fit_factors --num_layers 4 --d_model 512
"""

import argparse
from pathlib import Path

import torch

from kronfluence_tpu_torch import Analyzer, prepare_model
from kronfluence_tpu_torch.examples.common import example_device, synthetic_tokens
from kronfluence_tpu_torch.examples.openwebtext.task import LlamaMLPOnlyTask, MLPOnlyLMTask
from kronfluence_tpu_torch.models.llama import LlamaConfig, init_llama
from kronfluence_tpu_torch.models.transformer import TransformerConfig, init_transformer
from kronfluence_tpu_torch.parallel.mesh import make_mesh
from kronfluence_tpu_torch.utils.common.factor_arguments import (
    extreme_reduce_memory_factor_arguments,
)


def add_model_arguments(parser: argparse.ArgumentParser) -> None:
    """The model, data and device arguments fit_factors and compute_scores share."""
    parser.add_argument("--arch", choices=("gpt2", "llama"), default="gpt2",
                        help="llama = RMSNorm/RoPE/GQA/SwiGLU, no-bias Linear "
                             "(the reference's actual 8B architecture)")
    parser.add_argument("--num_layers", type=int, default=4)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--d_mlp", type=int, default=None,
                        help="llama MLP width (real 8B: 14336)")
    parser.add_argument("--num_heads", type=int, default=8)
    parser.add_argument("--num_kv_heads", type=int, default=None)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--vocab", type=int, default=8192)
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--per_device_batch_size", type=int, default=4)
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument("--attention", choices=("naive", "flash"), default="naive",
                        help="flash: the port's flash kernels (the JAX package's KRON_FLASH_ATTN)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    parser.add_argument("--output_dir", default="./influence_results/openwebtext")


def construct_model(args, device: torch.device):
    """The bf16 model the arguments describe, weights from seed 0, and its task."""
    if args.arch == "llama":
        config = LlamaConfig(
            vocab_size=args.vocab, max_seq_len=args.seq_len,
            num_layers=args.num_layers, num_heads=args.num_heads,
            num_kv_heads=args.num_kv_heads or max(1, args.num_heads // 4),
            d_model=args.d_model, d_mlp=args.d_mlp or (args.d_model * 7 // 2),
            dtype=torch.bfloat16, attention=args.attention,
        )
        return init_llama(config, seed=0, device=device), LlamaMLPOnlyTask(args.num_layers)
    config = TransformerConfig(
        vocab_size=args.vocab, max_seq_len=args.seq_len,
        num_layers=args.num_layers, num_heads=args.num_heads, d_model=args.d_model,
        dtype=torch.bfloat16, attention=args.attention,
    )
    return init_transformer(config, seed=0, device=device), MLPOnlyLMTask(args.num_layers)


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_arguments(parser)
    parser.add_argument("--module_partitions", type=int, default=2)
    parser.add_argument("--data_partitions", type=int, default=2)
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    # A data mesh of the processes running this script. The model axis (the
    # JAX package's FSDP sharding) is not ported: model > 1 raises, and at
    # model 1 every rank holds the whole model, as shard_params_fsdp leaves it.
    mesh = make_mesh(model=args.model_parallel, device=device)
    print(f"mesh: data {mesh.data}, model {args.model_parallel}")
    module, task = construct_model(args, device)
    model = prepare_model(module, task)
    train_data = synthetic_tokens(args.num_train, args.seq_len, args.vocab, seed=0)

    factor_args = extreme_reduce_memory_factor_arguments(
        strategy="ekfac", module_partitions=args.module_partitions
    )
    factor_args.covariance_data_partitions = args.data_partitions
    factor_args.lambda_data_partitions = args.data_partitions
    factor_args.eigendecomposition_dtype = "float32"  # on-device eigendecomposition
    # The recipe's solver: blocked Jacobi; the >= LARGE_EIGH_DIM factors
    # (14336 at the 8B widths) go through its host-loop form one at a time.
    factor_args.eigendecomposition_solver = "jacobi"

    analyzer = Analyzer("openwebtext", model, task, mesh=mesh,
                        output_dir=args.output_dir, profile=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.per_device_batch_size,
        factor_args=factor_args,
    )
    print("factor fitting complete; artifacts (partitioned + aggregated):")
    for f in sorted(Path(analyzer.factors_output_dir("ekfac")).glob("*.safetensors")):
        print(" ", f.name)
    print(analyzer.profiler.summary())
    if device.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
              f"of {torch.cuda.get_device_properties(device).total_memory / 2**30:.2f} GiB")
    return analyzer


if __name__ == "__main__":
    main()
