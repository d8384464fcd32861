"""Weight conversion from the JAX package's flax models.

`state_dict_from_flax` turns a flax param tree (leaves as numpy arrays) into
a `state_dict` for the port's model: for a `TransformerConfig` the port's
`TransformerLM`, for a `LlamaConfig` its `LlamaLM`, and for a vision module
(`SmallCNN`, `ResNet9`, `ResNet`) that module itself:

  * a Dense `kernel` (in, out) becomes a Linear `weight` (out, in);
  * a Conv `kernel` (kh, kw, in, out), flax's HWIO, becomes a Conv2d `weight`
    (out, in, kh, kw), torch's OIHW;
  * an Embed `embedding` is copied as it is;
  * a LayerNorm `scale` / `bias`, an RMSNorm `scale` and a BatchNorm `scale` /
    `bias` become `weight` / `bias`;
  * a BatchNorm's `batch_stats` `mean` / `var` become `running_mean` /
    `running_var` (both sides use eps 1e-5), and its `num_batches_tracked`
    is 0;
  * `lm_head/kernel` (d, vocab) becomes `lm_head.weight` (vocab, d).

The flax path `h_0/attn/c_attn` is the torch qualified name `h_0.attn.c_attn`
(`layers_0/mlp/gate_proj` is `layers_0.mlp.gate_proj`, `res1/block_0/conv`
is `res1.block_0.conv`). Any port module whose names are the flax paths
converts the same way: `MLP`, `RepeatedMLP` (models/mlp.py) and `EncDecLM`
(models/encoder_decoder.py) are passed as the module.

`scanned_params_from_flax` carries the JAX package's scanned GPT-2 params
(`stack_layer_params`: `blocks` leaves with a leading layer axis) to the
port's scanned layout (`models/transformer.py:stack_layer_params`).
"""

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from kronfluence_tpu_torch.models.llama import LlamaConfig, LlamaLM
from kronfluence_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    stack_layer_params,
)

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _leaves(params: Mapping[str, Any]):
    """(path, leaf, torch leaf name) of a param tree, or of flax variables
    {"params": ..., "batch_stats": ...}."""
    if set(params) <= {"params", "batch_stats"}:
        collections = [(params.get("params", {}), _LEAF_NAMES),
                       (params.get("batch_stats", {}), _STAT_NAMES)]
    else:
        collections = [(params, _LEAF_NAMES)]
    for tree, names in collections:
        for path, leaf in _flatten(tree):
            if path[-1] not in names:
                raise ValueError(f"Unexpected flax parameter {'/'.join(path)!r}.")
            yield path, leaf, names[path[-1]]


def state_dict_from_flax(
    params: Mapping[str, Any], config: Union[TransformerConfig, LlamaConfig, nn.Module]
) -> Dict[str, torch.Tensor]:
    """Converts flax TransformerLM or LlamaLM params, or a vision model's
    variables (params and batch_stats), with numpy leaves, to a torch
    state_dict: in `config.dtype` for a language model's config, in the dtype
    of its parameters for a vision module. Raises if the two sets do not line
    up."""
    if isinstance(config, nn.Module):
        expected = config.state_dict()
        dtype = next(config.parameters()).dtype
    else:
        model_type = LlamaLM if isinstance(config, LlamaConfig) else TransformerLM
        expected = model_type(config, device="meta").state_dict()
        dtype = config.dtype
    state: Dict[str, torch.Tensor] = {}
    for path, leaf, name in _leaves(params):
        array = np.array(leaf, copy=True)
        if path[-1] == "kernel":
            array = array.transpose(3, 2, 0, 1) if array.ndim == 4 else array.T
        key = ".".join(path[:-1] + (name,))
        state[key] = torch.from_numpy(np.ascontiguousarray(array)).to(dtype)
    for key in expected:
        prefix, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked" and f"{prefix}.running_mean" in state:
            state[key] = torch.zeros((), dtype=torch.int64)

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


def _layer_slice(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {
        key: _layer_slice(value, i) if isinstance(value, Mapping) else np.asarray(value)[i]
        for key, value in tree.items()
    }


def scanned_params_from_flax(params: Mapping[str, Any], config: TransformerConfig) -> Dict[str, Any]:
    """The JAX package's scanned GPT-2 params (numpy leaves; `blocks` stacked
    over `config.num_layers`) as the port's scanned params, in
    `config.dtype`: each layer is converted as `state_dict_from_flax`
    converts an unrolled block, then stacked again."""
    unrolled = {key: value for key, value in params.items() if key != "blocks"}
    for i in range(config.num_layers):
        unrolled[f"h_{i}"] = _layer_slice(params["blocks"], i)
    return stack_layer_params(state_dict_from_flax(unrolled, config), config.num_layers)
