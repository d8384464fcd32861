"""Shared example utilities: a small AdamW training loop, synthetic tokens,
the examples' language-model loss, a checkpoint writer and a printer of the
most influential training examples.

Port of `examples/common.py`. The training loop is `torch.optim.AdamW` over an
in-memory column store (a dict of equal-length numpy arrays), shuffled with
numpy's `default_rng(seed)`; a loss that samples draws from an explicit
`torch.Generator` seeded with the same seed.
"""

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.utils.save import save_file


def example_device(cpu: bool) -> torch.device:
    """`cuda:0` unless the caller asks for the CPU; no card raises."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA card is visible; pass --cpu to run the example on the CPU.")
    return torch.device("cuda", 0)


def synthetic_tokens(num: int, seq_len: int, vocab: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Uniform token ids in [1, vocab) and an all-ones mask, from `seed`."""
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(1, vocab, size=(num, seq_len)).astype(np.int32),
        "attention_mask": np.ones((num, seq_len), dtype=np.int32),
    }


def model_inputs(model, x: torch.Tensor) -> torch.Tensor:
    """`x` in the dtype of the model's parameters (the stages may cast the
    model to an amp dtype; the data stays fp32)."""
    return x.to(next(model.parameters()).dtype)


def sample_labels(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One label a position drawn from softmax(logits) by Gumbel-max, as
    `jax.random.categorical` draws them, with `generator`'s noise."""
    noise = torch.empty_like(logits).exponential_(generator=generator)
    labels = noise.log_().neg_().add_(logits.detach()).argmax(dim=-1)
    del noise
    return labels


def lm_loss(batch, model, sample: bool = False, generator=None) -> torch.Tensor:
    """The examples' summed next-token cross-entropy on fp32 logits over the
    shifted mask; `sample` draws the labels from the model (`sample_labels`)."""
    logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1].float()
    mask = batch["attention_mask"][:, 1:].to(torch.float32)
    if sample:
        labels = sample_labels(logits, generator)
    else:
        labels = batch["input_ids"][:, 1:].long()
    losses = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), reduction="none"
    ).reshape(mask.shape)
    return torch.sum(losses * mask)


def train_model(
    loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor], torch.Generator], torch.Tensor],
    model: nn.Module,
    data: Dict[str, np.ndarray],
    batch_size: int = 32,
    num_epochs: int = 5,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
) -> nn.Module:
    """Minimal AdamW training loop; trains `model` in place on its device and
    returns it. `loss_fn(model, batch, generator)` gives the scalar loss of a
    batch."""
    device = next(model.parameters()).device
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate, weight_decay=weight_decay)
    num = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device).manual_seed(seed)
    t0 = time.time()
    for epoch in range(num_epochs):
        order = rng.permutation(num)
        losses = []
        for start in range(0, num - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            batch = {k: torch.as_tensor(v[idx], device=device) for k, v in data.items()}
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch, generator)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
        print(f"epoch {epoch}: loss {np.mean(losses) if losses else float('nan'):.4f} "
              f"({time.time() - t0:.1f}s)")
    model.zero_grad(set_to_none=True)
    return model


def save_checkpoint(model: nn.Module, path) -> None:
    """The model's state_dict as one safetensors file."""
    save_file({k: v.detach() for k, v in model.state_dict().items()}, path)


def print_top_influences(scores, k: int = 5) -> None:
    """Prints the most positively and negatively influential train indices of
    the first three queries (rows of a (query, train) score matrix)."""
    scores = scores.double().cpu().numpy() if isinstance(scores, torch.Tensor) else scores
    for q in range(min(3, scores.shape[0])):
        row = scores[q]
        top = np.argsort(row)[::-1][:k]
        bottom = np.argsort(row)[:k]
        print(f"query {q}: top {top.tolist()} (scores {np.round(row[top], 3)}), "
              f"bottom {bottom.tolist()}")
