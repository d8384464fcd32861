"""Trains the summarization model and saves a checkpoint.

Port of `examples/dailymail/train.py`: an AdamW fine-tune of the
encoder-decoder on the summed masked cross-entropy a pair, the final
per-token train loss, and the trained weights as one safetensors file (which
`analyze` loads).

    python -m kronfluence_tpu_torch.examples.dailymail.train --num_train 128 --epochs 3
"""

import argparse
from pathlib import Path

import torch

from kronfluence_tpu_torch.examples.common import example_device, save_checkpoint, train_model
from kronfluence_tpu_torch.examples.dailymail.pipeline import (
    construct_seq2seq,
    get_dailymail_dataset,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=5e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", default=None, help="unused; smoke-test compat")
    parser.add_argument("--checkpoint_dir", default="./checkpoints/dailymail")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data = get_dailymail_dataset("train", args.num_train)
    module, task = construct_seq2seq(seed=args.seed, device=device)
    train_model(
        lambda m, b, g: task.compute_train_loss(b, m) / len(b["input_ids"]),
        module, train_data, batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=args.learning_rate, seed=args.seed,
    )
    with torch.no_grad():
        batch = {k: torch.as_tensor(v, device=device) for k, v in train_data.items()}
        loss = float(task.compute_train_loss(batch, module)) / float(
            train_data["decoder_attention_mask"][:, 1:].sum())
    print(f"final train loss/token: {loss:.4f}")

    out = Path(args.checkpoint_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_checkpoint(module, out / "model.safetensors")
    print(f"saved checkpoint to {out / 'model.safetensors'}")
    return module, loss


if __name__ == "__main__":
    main()
