"""Weight conversion from the JAX package's flax language models.

`state_dict_from_flax` turns a flax param tree (leaves as numpy arrays) into
a `state_dict` for the port's model of the config's type:
`kronfluence_tpu_torch.models.transformer.TransformerLM` for a
`TransformerConfig`, `kronfluence_tpu_torch.models.llama.LlamaLM` for a
`LlamaConfig`:

  * a Dense `kernel` (in, out) becomes a Linear `weight` (out, in);
  * an Embed `embedding` is copied as it is;
  * a LayerNorm `scale` / `bias` and an RMSNorm `scale` become `weight` / `bias`;
  * `lm_head/kernel` (d, vocab) becomes `lm_head.weight` (vocab, d).

The flax path `h_0/attn/c_attn` is the torch qualified name `h_0.attn.c_attn`
(`layers_0/mlp/gate_proj` is `layers_0.mlp.gate_proj`).
"""

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from kronfluence_tpu_torch.models.llama import LlamaConfig, LlamaLM
from kronfluence_tpu_torch.models.transformer import TransformerConfig, TransformerLM

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_flax(
    params: Mapping[str, Any], config: Union[TransformerConfig, LlamaConfig]
) -> Dict[str, torch.Tensor]:
    """Converts flax TransformerLM or LlamaLM params (numpy leaves) to a torch
    state_dict in `config.dtype`; raises if the two parameter sets do not
    line up."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        if path[-1] not in _LEAF_NAMES:
            raise ValueError(f"Unexpected flax parameter {'/'.join(path)!r}.")
        array = np.array(leaf, copy=True)
        if path[-1] == "kernel":
            array = array.T
        key = ".".join(path[:-1] + (_LEAF_NAMES[path[-1]],))
        state[key] = torch.from_numpy(np.ascontiguousarray(array)).to(config.dtype)

    model_type = LlamaLM if isinstance(config, LlamaConfig) else TransformerLM
    expected = model_type(config, device="meta").state_dict()
    if set(state) != set(expected):
        missing = sorted(set(expected) - set(state))
        extra = sorted(set(state) - set(expected))
        raise ValueError(f"flax params do not match the config: missing {missing}, extra {extra}.")
    for key, tensor in state.items():
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{key}: flax shape {tuple(tensor.shape)} vs torch {tuple(expected[key].shape)}."
            )
    return state
