"""Trains the SWAG choice scorer and saves a checkpoint.

Port of `examples/swag/train.py`: an AdamW fine-tune on the mean
cross-entropy over the choices, the train accuracy, and the trained weights as
one safetensors file.

    python -m kronfluence_tpu_torch.examples.swag.train --num_train 256 --epochs 3
"""

import argparse
from pathlib import Path

from kronfluence_tpu_torch.examples.common import example_device, save_checkpoint, train_model
from kronfluence_tpu_torch.examples.glue.train import accuracy
from kronfluence_tpu_torch.examples.swag.pipeline import construct_choice_model, get_swag_dataset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", default=None, help="unused; smoke-test compat")
    parser.add_argument("--checkpoint_dir", default="./checkpoints/swag")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data = get_swag_dataset("train", args.num_train)
    module, task = construct_choice_model(seed=args.seed, device=device)
    train_model(
        lambda m, b, g: task.compute_train_loss(b, m) / len(b["label"]),
        module, train_data, batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=args.learning_rate, seed=args.seed,
    )
    acc = accuracy(module, train_data)
    print(f"train accuracy: {acc:.3f}")

    out = Path(args.checkpoint_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_checkpoint(module, out / "model.safetensors")
    print(f"saved checkpoint to {out / 'model.safetensors'}")
    return module, acc


if __name__ == "__main__":
    main()
