"""Prints the most influential training pair for a query summary.

Port of `examples/dailymail/inspect_examples.py`: loads `analyze`'s saved
pairwise scores and prints the query's article and summary and those of its
top-scored training pair. The data is synthetic, so the token ids are printed
as they are (the JAX example decodes them with the T5 tokenizer under
`--real`, which is not ported).

    python -m kronfluence_tpu_torch.examples.dailymail.inspect_examples --eval_idx 1
"""

import argparse
from pathlib import Path

import numpy as np

from kronfluence_tpu_torch import Analyzer
from kronfluence_tpu_torch.examples.dailymail.pipeline import get_dailymail_dataset


def _decode(ids, mask) -> str:
    return np.array2string(np.asarray(ids)[np.asarray(mask) > 0], threshold=16)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval_idx", type=int, default=1)
    parser.add_argument("--num_train", type=int, default=128)
    parser.add_argument("--num_query", type=int, default=8)
    parser.add_argument("--scores_name", default="pairwise")
    parser.add_argument("--output_dir", default="./influence_results/dailymail")
    parser.add_argument("--cpu", action="store_true",
                        help="accepted for symmetry with the other scripts; reads files only")
    args = parser.parse_args(argv)

    path = (Path(args.output_dir) / "dailymail" / f"scores_{args.scores_name}"
            / "pairwise_scores.safetensors")
    scores = Analyzer.load_file(path)["all_modules"].float().cpu().numpy()
    train_data = get_dailymail_dataset("train", args.num_train, seed=0)
    query_data = get_dailymail_dataset("valid", args.num_query, seed=1)

    qi = args.eval_idx
    print("Query Data Example:")
    print(f"  Input: {_decode(query_data['input_ids'][qi], query_data['attention_mask'][qi])}")
    print(f"  Label: {_decode(query_data['decoder_input_ids'][qi], query_data['decoder_attention_mask'][qi])}")
    top_idx = int(np.argsort(-scores[qi])[0])
    print(f"Top Influential Example (train idx {top_idx}, score {scores[qi, top_idx]:.3e}):")
    print(f"  Input: {_decode(train_data['input_ids'][top_idx], train_data['attention_mask'][top_idx])}")
    print(f"  Label: {_decode(train_data['decoder_input_ids'][top_idx], train_data['decoder_attention_mask'][top_idx])}")
    return top_idx, float(scores[qi, top_idx])


if __name__ == "__main__":
    main()
