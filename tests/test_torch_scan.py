"""The scanned GPT-2 (models/transformer.py:scanned_lm_apply over
stack_layer_params) and `scan_layers` on the CPU in fp64:

  * through the four stages and both score kinds against the JAX package's
    `scanned_lm_apply` on the same seeded weights and data (d 128, two heads
    of 64, T 128, two layers), with naive attention and with flash attention
    (the kernels' plain versions), at the reference tolerance; the JAX side,
    whose attention is its naive route either way, runs once;
  * against the port's `TransformerLM` on the same weights, bit for bit;
  * with `remat=True` (each block a `checkpoint_block`): the same bits, and
    fewer bytes kept for the backward;
  * `scan_layers` outside a capture context equals a plain loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.models.transformer import scanned_lm_apply as jax_scanned_lm_apply
from kronfluence_tpu.models.transformer import stack_layer_params as jax_stack_layer_params
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu_torch import FunctionalModel
from kronfluence_tpu_torch.capture.engine import discover_specs
from kronfluence_tpu_torch.models.convert import scanned_params_from_flax, state_dict_from_flax
from kronfluence_tpu_torch.models.transformer import scanned_lm_apply, stack_layer_params
from kronfluence_tpu_torch.nn import scan_layers
from kronfluence_tpu_torch.ops.attention import naive_attention
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.utils.memory import autograd_bytes

from tests.testable_tasks.language_modeling import make_lm, make_lm_data
from tests.testable_tasks.parity import (
    assert_bitwise,
    assert_factors_match,
    assert_scores_match,
    jax_stages,
    torch_stages,
)
from tests.testable_tasks.torch_language_modeling import (
    TorchLanguageModelingTask,
    make_torch_lm,
    torch_config_like,
)

NUM_TRAIN, BATCH, NUM_QUERY, QUERY_BATCH = 6, 3, 4, 2
# The flash kernels take T a multiple of 128 and head_dim 64.
SEQ, CONFIG = 128, dict(max_seq_len=128, d_model=128, num_heads=2)
PROJECTIONS = ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


class BlockTask(TorchLanguageModelingTask):
    """The four projections of every block: the scanned form's names (its
    head is untracked, as in the JAX package's scanned form)."""

    def __init__(self, num_layers):
        self.num_layers = num_layers

    def get_influence_tracked_modules(self):
        return block_names(self.num_layers)


def block_names(num_layers):
    return [f"h_{i}/{p}" for i in range(num_layers) for p in PROJECTIONS]


def scanned_model(params, jconfig, attention, remat=False):
    config = torch_config_like(jconfig, attention=attention)
    host = jax.tree_util.tree_map(np.asarray, jax_stack_layer_params(params, config.num_layers))
    stacked = scanned_params_from_flax(host, config)
    return prepare_model(FunctionalModel(scanned_lm_apply(config, remat), stacked)), config


@pytest.fixture(scope="module")
def jax_run():
    _, params, jtask, jconfig = make_lm(**CONFIG)
    train = make_lm_data(NUM_TRAIN, seq_len=SEQ, vocab=128, seed=0)
    query = make_lm_data(NUM_QUERY, seq_len=SEQ, vocab=128, seed=1)
    stacked = jax_stack_layer_params(params, jconfig.num_layers)
    jmodel = jax_prepare(jax_scanned_lm_apply(jconfig), jtask)
    want = jax_stages(jmodel, stacked, jtask, train, query, BATCH, QUERY_BATCH)
    return params, jconfig, train, query, stacked, want


@pytest.fixture(scope="module", params=["naive", "flash"])
def run(request, jax_run):
    attention = request.param
    params, jconfig, train, query, stacked, want = jax_run
    task = TorchLanguageModelingTask()
    calls = naive_attention.calls
    scanned, _ = scanned_model(params, jconfig, attention)
    remat, _ = scanned_model(params, jconfig, attention, remat=True)
    got = torch_stages(scanned, task, train, query, BATCH, QUERY_BATCH)
    got_remat = torch_stages(remat, task, train, query, BATCH, QUERY_BATCH)
    module, _, _ = make_torch_lm(params, jconfig, attention=attention)
    block_task = BlockTask(jconfig.num_layers)
    module = prepare_model(module.module, block_task)
    module_form = torch_stages(module, block_task, train, query, BATCH, QUERY_BATCH)
    assert (naive_attention.calls == calls) == (attention == "flash")
    return dict(attention=attention, params=params, jconfig=jconfig, stacked=stacked,
                train=train, want=want, got=got, remat=got_remat, module_form=module_form,
                scanned=scanned, module=module)


def test_factors_match_jax(run):
    assert_factors_match(run["got"][0], run["want"][0], block_names(run["jconfig"].num_layers))


def test_scores_match_jax(run):
    assert_scores_match(run["got"][1], run["want"][1], (NUM_QUERY, NUM_TRAIN))
    assert_scores_match(run["got"][2], run["want"][2], (NUM_TRAIN,))


@pytest.mark.parametrize("part", [0, 1, 2], ids=["factors", "pairwise", "self"])
def test_scanned_equals_module_form_bitwise(run, part):
    assert_bitwise(run["got"][part], run["module_form"][part])


@pytest.mark.parametrize("part", [0, 1, 2], ids=["factors", "pairwise", "self"])
def test_remat_is_bitwise(run, part):
    assert_bitwise(run["remat"][part], run["got"][part])


def test_tracked_names_and_specs_are_the_module_forms(run):
    """The scanned form taps the module form's names, in its order, with its
    specs; the module form's head is the one name more."""
    batch = {k: torch.from_numpy(v[:2]) for k, v in run["train"].items()}

    def forward(model):
        return lambda: model.module(batch["input_ids"], batch["attention_mask"]).sum()

    module = prepare_model(run["module"].module)
    scanned = discover_specs(run["scanned"], forward(run["scanned"]))
    module_specs = discover_specs(module, forward(module))
    assert list(scanned) == block_names(run["jconfig"].num_layers)
    assert list(module_specs) == list(scanned) + ["lm_head"]
    assert all(module_specs[name] == spec for name, spec in scanned.items())


def test_forward_matches_jax_scanned(run):
    """Logits at the valid positions (padded rows differ between the naive
    and flash forms) against the JAX package's scanned forward."""
    ids, mask = run["train"]["input_ids"], run["train"]["attention_mask"]
    want = np.asarray(jax_scanned_lm_apply(run["jconfig"])(run["stacked"], jnp.asarray(ids),
                                                           jnp.asarray(mask)))
    with torch.no_grad():
        got = run["scanned"].module(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-10, atol=1e-10)


def test_scanned_params_from_flax_equal_stacked_state_dict():
    """JAX's scanned layout carried across equals the port's stacking of the
    converted unrolled weights, leaf for leaf."""
    _, params, _, jconfig = make_lm()
    config = torch_config_like(jconfig)
    host = jax.tree_util.tree_map(np.asarray, jax_stack_layer_params(params, jconfig.num_layers))
    got = scanned_params_from_flax(host, config)
    want = stack_layer_params(
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), config),
        config.num_layers)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]

    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want) and "blocks.attn.c_attn.weight" in got
    assert got["blocks.attn.c_attn.weight"].shape == (2, 96, 32)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="beyond num_layers"):
        stack_layer_params(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                config), 1)


def test_remat_keeps_fewer_bytes():
    """With each block checkpointed, autograd keeps less for the backward
    (the blocks' intermediates are recomputed)."""
    _, params, _, jconfig = make_lm()
    task = TorchLanguageModelingTask()
    batch = {k: torch.from_numpy(v) for k, v in make_lm_data(4, seed=2).items()}
    plain, _ = scanned_model(params, jconfig, "naive")
    remat, _ = scanned_model(params, jconfig, "naive", remat=True)
    assert autograd_bytes(remat, task, batch, 4) < autograd_bytes(plain, task, batch, 4)


@pytest.mark.parametrize("remat", [False, True])
def test_scan_layers_outside_a_context_is_a_loop(remat):
    """Outside a capture context: a plain loop over the leading axis, ys
    stacked (a dict of them, or None), the gradient the loop's."""
    gen = torch.Generator().manual_seed(0)
    xs = {"w": torch.randn(3, 4, 4, generator=gen, dtype=torch.float64),
          "b": torch.randn(3, 4, generator=gen, dtype=torch.float64)}
    init = torch.randn(2, 4, generator=gen, dtype=torch.float64)

    def body(h, p):
        h = torch.tanh(h @ p["w"] + p["b"])
        return h, {"mean": h.mean(), "first": h[0]}

    h1 = init.clone().requires_grad_(True)
    carry, ys = scan_layers(body, h1, xs, remat=remat)
    h2 = init.clone().requires_grad_(True)
    want, outs = h2, []
    for i in range(3):
        want, y = body(want, {k: v[i] for k, v in xs.items()})
        outs.append(y)
    assert torch.equal(carry, want)
    assert torch.equal(ys["mean"], torch.stack([y["mean"] for y in outs]))
    assert torch.equal(ys["first"], torch.stack([y["first"] for y in outs]))
    carry.sum().backward()
    want.sum().backward()
    assert torch.equal(h1.grad, h2.grad)
    _, none = scan_layers(lambda h, p: (h, None), init, xs)
    assert none is None
