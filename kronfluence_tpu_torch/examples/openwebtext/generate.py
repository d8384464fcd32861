"""Greedy generation and influence attribution of the generated completion.

Port of `examples/openwebtext/generate.py`: greedy decode with the GPT-2
TransformerLM (the full forward recomputed for each new token), then pairwise
scores whose measurement is the completion's negative log-likelihood given
the prompt: which training sequences most influenced that completion.

    python -m kronfluence_tpu_torch.examples.openwebtext.generate --prompt_len 16 --gen_len 16
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, prepare_model
from kronfluence_tpu_torch.examples.common import example_device
from kronfluence_tpu_torch.examples.openwebtext.task import MLPOnlyLMTask
from kronfluence_tpu_torch.models.transformer import TransformerConfig, init_transformer


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--d_model", type=int, default=128)
    parser.add_argument("--num_heads", type=int, default=2)
    parser.add_argument("--vocab", type=int, default=512)
    parser.add_argument("--prompt_len", type=int, default=16)
    parser.add_argument("--gen_len", type=int, default=16)
    parser.add_argument("--num_train", type=int, default=64)
    parser.add_argument("--per_device_batch_size", type=int, default=8)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    parser.add_argument("--output_dir", default="./influence_results/openwebtext_gen")
    return parser.parse_args(argv)


class CompletionTask(MLPOnlyLMTask):
    """Measurement = the negative log-likelihood of the completion tokens
    only (prompt positions masked out)."""

    def __init__(self, num_layers: int, prompt_len: int):
        super().__init__(num_layers)
        self.prompt_len = prompt_len

    def compute_measurement(self, batch, model):
        logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1].float()
        labels = batch["input_ids"][:, 1:].long()
        mask = batch["attention_mask"][:, 1:].to(torch.float32)
        position = torch.arange(labels.shape[1], device=labels.device)[None, :]
        completion_mask = (position >= self.prompt_len - 1).to(torch.float32)
        losses = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), reduction="none"
        ).reshape(mask.shape)
        return torch.sum(losses * mask * completion_mask)


@torch.no_grad()
def greedy_generate(module, prompt: np.ndarray, gen_len: int) -> np.ndarray:
    """Greedy decode by recomputing the whole forward for each new token."""
    device = next(module.parameters()).device
    tokens = torch.as_tensor(prompt, device=device)
    for _ in range(gen_len):
        logits = module(tokens, torch.ones_like(tokens))
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        tokens = torch.cat([tokens, nxt.to(tokens.dtype)], dim=1)
    return tokens.cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args.cpu)
    seq_len = args.prompt_len + args.gen_len
    config = TransformerConfig(
        vocab_size=args.vocab, max_seq_len=seq_len,
        num_layers=args.num_layers, num_heads=args.num_heads, d_model=args.d_model,
    )
    module = init_transformer(config, seed=0, device=device)

    rng = np.random.default_rng(0)
    prompt = rng.integers(1, args.vocab, size=(1, args.prompt_len)).astype(np.int32)
    completion = greedy_generate(module, prompt, args.gen_len)
    print(f"prompt tokens:     {prompt[0].tolist()}")
    print(f"generated tokens:  {completion[0, args.prompt_len:].tolist()}")

    task = CompletionTask(args.num_layers, args.prompt_len)
    model = prepare_model(module, task)
    train_data = {
        "input_ids": rng.integers(1, args.vocab, size=(args.num_train, seq_len)).astype(np.int32),
        "attention_mask": np.ones((args.num_train, seq_len), dtype=np.int32),
    }
    query_data = {"input_ids": completion, "attention_mask": np.ones_like(completion)}

    analyzer = Analyzer("openwebtext_gen", model, task, cpu=device.type == "cpu",
                        output_dir=args.output_dir, disable_tqdm=True)
    analyzer.fit_all_factors(
        "ekfac", train_data, per_device_batch_size=args.per_device_batch_size,
        factor_args=FactorArguments(strategy="ekfac"), overwrite_output_dir=True,
    )
    analyzer.compute_pairwise_scores(
        "generation", "ekfac", query_data, train_data,
        per_device_query_batch_size=1,
        per_device_train_batch_size=args.per_device_batch_size,
        score_args=ScoreArguments(), overwrite_output_dir=True,
    )
    scores = analyzer.load_pairwise_scores("generation")["all_modules"][0].double().cpu().numpy()
    top = np.argsort(scores)[::-1][:8]
    print(f"training sequences most influential for this generation: {top.tolist()}")
    print(f"scores: {np.round(scores[top], 3)}")
    return completion, scores


if __name__ == "__main__":
    main()
