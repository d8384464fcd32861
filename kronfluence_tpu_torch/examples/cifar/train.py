"""Trains ResNet-9 on CIFAR-10-shaped data and saves the checkpoint.

Port of `examples/cifar/train.py`: `train_resnet9`'s AdamW recipe, then the
trained weights and BatchNorm statistics as one safetensors file, and the
corrupted labels' indices beside it when `--corrupt_frac` corrupts any.

    python -m kronfluence_tpu_torch.examples.cifar.train --num_train 1024 --epochs 10
"""

import argparse
from pathlib import Path

import numpy as np

from kronfluence_tpu_torch.examples.cifar.pipeline import get_cifar10_dataset, train_resnet9
from kronfluence_tpu_torch.examples.common import example_device, save_checkpoint


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=1024)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--corrupt_frac", type=float, default=0.0)
    parser.add_argument("--output_dir", default=None, help="unused; smoke-test compat")
    parser.add_argument("--checkpoint_dir", default="./checkpoints/cifar")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data, corrupt_idx = get_cifar10_dataset(
        "train", args.num_train, corrupt_frac=args.corrupt_frac
    )
    module, _, _ = train_resnet9(
        train_data, epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay, device=device,
    )
    out = Path(args.checkpoint_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_checkpoint(module, out / "model.safetensors")
    if len(corrupt_idx):
        np.save(out / "corrupt_idx.npy", corrupt_idx)
    print(f"saved checkpoint to {out / 'model.safetensors'}")
    return module, corrupt_idx


if __name__ == "__main__":
    main()
