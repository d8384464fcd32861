"""Trains the WikiText-2 GPT-2-class LM and saves a checkpoint.

Port of `examples/wikitext/train.py`: an AdamW fine-tune, train and
evaluation perplexity, and a checkpoint of the trained weights.

    python -m kronfluence_tpu_torch.examples.wikitext.train --num_train 64 --epochs 1 --num_layers 2
"""

import argparse
import math
from pathlib import Path

import torch

from kronfluence_tpu_torch.examples.common import example_device, save_checkpoint, train_model
from kronfluence_tpu_torch.examples.wikitext.pipeline import (
    LanguageModelingTask,
    construct_gpt2,
    get_wikitext_dataset,
)


@torch.no_grad()
def evaluate_loss(model, task, data, batch_size: int) -> float:
    """Mean per-token next-token cross-entropy over `data`."""
    device = next(model.parameters()).device
    num = len(data["input_ids"])
    total_loss, total_tokens = 0.0, 0.0
    for start in range(0, num, batch_size):
        batch = {k: torch.as_tensor(v[start : start + batch_size], device=device)
                 for k, v in data.items()}
        total_loss += float(task.compute_train_loss(batch, model))
        total_tokens += float(batch["attention_mask"][:, 1:].sum())
    return total_loss / max(1.0, total_tokens)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_train", type=int, default=64)
    parser.add_argument("--num_eval", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--eval_batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=3e-5)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--num_layers", type=int, default=12)
    parser.add_argument("--d_model", type=int, default=768)
    parser.add_argument("--num_heads", type=int, default=12)
    parser.add_argument("--vocab", type=int, default=50257)
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--seed", type=int, default=1004)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    parser.add_argument("--checkpoint_dir", default="./checkpoints/wikitext")
    args = parser.parse_args(argv)

    device = example_device(args.cpu)
    train_data = get_wikitext_dataset(
        "train", args.num_train, seq_len=args.seq_len, vocab=args.vocab
    )
    model = construct_gpt2(
        num_layers=args.num_layers, d_model=args.d_model, num_heads=args.num_heads,
        seq_len=args.seq_len, vocab=args.vocab, seed=args.seed, device=device,
    )
    task = LanguageModelingTask(num_layers=args.num_layers)

    def loss_fn(m, batch, generator):
        total = task.compute_train_loss(batch, m)
        return total / batch["attention_mask"][:, 1:].sum().clamp_min(1)

    train_model(
        loss_fn, model, train_data, batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay, seed=args.seed,
    )
    train_loss = evaluate_loss(model, task, train_data, args.eval_batch_size)
    print(f"train perplexity: {math.exp(min(30.0, train_loss)):.3f}")
    eval_data = get_wikitext_dataset(
        "valid", args.num_eval, seq_len=args.seq_len, vocab=args.vocab
    )
    eval_loss = evaluate_loss(model, task, eval_data, args.eval_batch_size)
    print(f"evaluation perplexity: {math.exp(min(30.0, eval_loss)):.3f}")

    out = Path(args.checkpoint_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_checkpoint(model, out / "model.safetensors")
    print(f"saved checkpoint to {out / 'model.safetensors'}")
    return model, train_loss, eval_loss


if __name__ == "__main__":
    main()
