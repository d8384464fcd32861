"""The port's TransformerLM against the flax TransformerLM on the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from kronfluence_tpu_torch.models.convert import state_dict_from_flax
from kronfluence_tpu_torch.models.transformer import (
    TransformerLM,
    gpt2_small,
    init_transformer,
    tiny_config,
)

from tests.testable_tasks.language_modeling import make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import make_torch_lm, torch_config_like


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def lm():
    """One flax init (fp64 params) shared by the file's tests."""
    _, params, _, config = make_lm()
    return params, config


def _logits_pair(lm, jdtype, tdtype):
    params, config = lm
    config = dataclasses.replace(config, dtype=jdtype, param_dtype=jdtype)
    params = jax.tree_util.tree_map(lambda p: p.astype(jdtype), params)
    tmodel, _, _ = make_torch_lm(params, config, dtype=tdtype)
    data = make_lm_data(6, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=3)
    assert (data["attention_mask"] == 0).any(), "the data must carry padding"
    want = np.asarray(
        FlaxTransformerLM(config).apply(
            {"params": params}, jnp.asarray(data["input_ids"]), jnp.asarray(data["attention_mask"])
        )
    )
    with torch.no_grad():
        got = tmodel.module(
            torch.from_numpy(data["input_ids"]), torch.from_numpy(data["attention_mask"])
        ).numpy()
    return got, want, data["attention_mask"].astype(bool)


@pytest.mark.parametrize(
    "jdtype,tdtype,rtol",
    [
        # fp32: LayerNorm variance (flax E[x^2]-E[x]^2 vs torch two-pass),
        # softmax and matmul orders differ at fp32 ulps; 1e-5 of the logit
        # scale bounds them.
        (jnp.float32, torch.float32, 1e-5),
        (jnp.float64, torch.float64, 1e-11),
    ],
)
def test_logits_match_flax_at_valid_positions(lm, jdtype, tdtype, rtol):
    got, want, valid = _logits_pair(lm, jdtype, tdtype)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[valid], want[valid], rtol=rtol, atol=rtol * scale)


def test_module_names_are_flax_paths(lm):
    params, config = lm
    tmodel, _, _ = make_torch_lm(params, config)
    names = set(tmodel.tracked_modules())
    flax_dense = {
        "/".join(str(k.key) for k in path[:-1])
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
        if str(path[-1].key) == "kernel"
    }
    assert names == flax_dense
    assert "h_0/attn/c_attn" in names and "lm_head" in names


def test_converter_rejects_mismatched_config(lm):
    params, config = lm
    host = jax.tree_util.tree_map(np.asarray, params)
    wrong = dataclasses.replace(torch_config_like(config), num_layers=config.num_layers + 1)
    with pytest.raises(ValueError, match="missing"):
        state_dict_from_flax(host, wrong)


def test_seeded_init_is_deterministic():
    config = tiny_config()
    a = init_transformer(config, seed=0, device="cpu").state_dict()
    b = init_transformer(config, seed=0, device="cpu").state_dict()
    c = init_transformer(config, seed=1, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["h_0.attn.c_attn.weight"], c["h_0.attn.c_attn.weight"])


def test_gpt2_small_shapes():
    config = gpt2_small(max_seq_len=512)
    model = TransformerLM(config, device="meta")
    assert model.wte.weight.shape == (50257, 768)
    assert model.wpe.weight.shape == (512, 768)
    assert model.h_11.attn.c_attn.weight.shape == (2304, 768)
    assert model.h_11.mlp.c_fc.weight.shape == (3072, 768)
    assert model.lm_head.bias is None
    assert model.h_0.ln_1.eps == 1e-6
