"""Trains the UCI regression MLP and saves a checkpoint.

Port of `examples/uci/train.py`: AdamW on the mean squared error, then the
trained weights as one safetensors file.

    python -m kronfluence_tpu_torch.examples.uci.train --num_train 512 --epochs 20
"""

import argparse
from pathlib import Path

from kronfluence_tpu_torch.examples.common import example_device, save_checkpoint, train_model
from kronfluence_tpu_torch.examples.uci.pipeline import (
    RegressionTask,
    construct_regression_mlp,
    get_regression_dataset,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=512)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint_dir", default="./checkpoints/uci")
    parser.add_argument("--output_dir", default=None, help="unused; smoke-test compat")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args.cpu)
    train_data = get_regression_dataset("train", args.num_train, seed=args.seed)
    model = construct_regression_mlp(seed=args.seed, device=device)
    task = RegressionTask()
    train_model(
        lambda m, b, g: task.compute_train_loss(b, m) / len(b["y"]),
        model, train_data, batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=args.learning_rate, seed=args.seed,
    )
    out = Path(args.checkpoint_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_checkpoint(model, out / "model.safetensors")
    print(f"Saved checkpoint to {out / 'model.safetensors'}")
    return model


if __name__ == "__main__":
    main()
