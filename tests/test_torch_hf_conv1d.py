"""HF GPT-2's `Conv1D` (a dense layer with a transposed weight) captured by
the port without model surgery, as the JAX package captures `FlaxConv1D`
(capture/flax_integration.py:61-81):

  * a stand-in class named `Conv1D` against an `nn.Linear` holding the
    transposed weight (needs no `transformers`);
  * a random-init tiny `transformers.GPT2LMHeadModel` in torch, in fp64,
    through the four stages and both score kinds against the JAX package on
    `FlaxGPT2LMHeadModel` (tests/test_hf_flax.py) with the weights carried
    across, at the reference tolerance.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.capture.context import hf_conv1d_spec, is_hf_conv1d
from kronfluence_tpu_torch.capture.engine import capture, discover_specs
from kronfluence_tpu_torch.capture.specs import LayerSpec
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.task import Task

NUM_TRAIN, BATCH, NUM_QUERY, QUERY_BATCH = 6, 3, 4, 2
SEQ, VOCAB = 16, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


class Conv1D(nn.Module):
    """transformers.pytorch_utils.Conv1D as it is written: weight (nx, nf)."""

    def __init__(self, nf, nx):
        super().__init__()
        self.nf, self.nx = nf, nx
        self.weight = nn.Parameter(torch.empty(nx, nf, dtype=torch.float64))
        self.bias = nn.Parameter(torch.zeros(nf, dtype=torch.float64))

    def forward(self, x):
        size_out = x.size()[:-1] + (self.nf,)
        return torch.addmm(self.bias, x.view(-1, x.size(-1)), self.weight).view(size_out)


class Net(nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.fc = layer(8, 12)
        self.out = layer(12, 3)

    def forward(self, x):
        return self.out(F.relu(self.fc(x)))


def _pair():
    gen = torch.Generator().manual_seed(0)
    conv = Net(lambda nx, nf: Conv1D(nf, nx))
    linear = Net(lambda nx, nf: nn.Linear(nx, nf, dtype=torch.float64))
    with torch.no_grad():
        for name in ("fc", "out"):
            c, lin = getattr(conv, name), getattr(linear, name)
            c.weight.copy_(torch.randn(c.weight.shape, generator=gen, dtype=torch.float64))
            c.bias.copy_(torch.randn(c.bias.shape, generator=gen, dtype=torch.float64))
            lin.weight.copy_(c.weight.T)
            lin.bias.copy_(c.bias)
    return conv, linear


def test_stand_in_conv1d_is_a_linear_layer():
    conv, linear = _pair()
    assert is_hf_conv1d(conv.fc) and not is_hf_conv1d(linear.fc)
    assert hf_conv1d_spec("fc", conv.fc) == LayerSpec(name="fc", kind="linear", has_bias=True,
                                                     in_dim=8, out_dim=12)
    x = torch.randn(5, 7, 8, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    models = [prepare_model(m) for m in (conv, linear)]
    specs = [discover_specs(m, lambda m=m: m.module(x).sum()) for m in models]
    assert specs[0] == specs[1] and list(specs[0]) == ["fc", "out"]
    (_, got), (_, want) = (capture(m, lambda m=m: (m.module(x) ** 2).sum()) for m in models)
    for name in ("fc", "out"):
        assert torch.equal(got[name].activations[0], want[name].activations[0])
        torch.testing.assert_close(got[name].output_gradients[0], want[name].output_gradients[0],
                                   rtol=1e-13, atol=1e-13)


def test_a_class_named_conv1d_without_its_shape_is_not_tracked():
    class Conv1D(nn.Module):  # noqa: F811 (another class of the name)
        def __init__(self):
            super().__init__()
            self.weight = nn.Parameter(torch.ones(3, 4))

    module = Conv1D()
    assert not is_hf_conv1d(module)
    module.nf = 3  # weight (3, 4) is not (nx, nf) for nf 3
    assert not is_hf_conv1d(module)


# ---- A tiny HF GPT-2 against the JAX package's FlaxGPT2LMHeadModel ----


class TorchGPT2Task(Task):
    """Torch twin of tests/test_hf_flax.py:GPT2Task."""

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        mask = batch["attention_mask"]
        logits = model(batch["input_ids"], attention_mask=mask,
                       position_ids=torch.cumsum(mask, dim=1) - 1).logits[:, :-1]
        loss_mask = mask[:, 1:].to(logits.dtype)
        vocab = logits.shape[-1]
        if sample:
            probs = torch.softmax(logits.detach().reshape(-1, vocab), dim=-1)
            labels = torch.multinomial(probs, 1, generator=generator).reshape(loss_mask.shape)
        else:
            labels = batch["input_ids"][:, 1:].long()
        losses = F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1),
                                 reduction="none").reshape(loss_mask.shape)
        return torch.sum(losses * loss_mask)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)

    def get_attention_mask(self, batch):
        return batch["attention_mask"]


def _torch_state_dict(flax_params):
    """FlaxGPT2LMHeadModel params (numpy) as GPT2LMHeadModel's state_dict:
    FlaxConv1D kernels are (out, in), torch Conv1D weights (in, out); the
    head is tied to the token embedding."""
    names = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
    state = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                array = value.T if key == "kernel" else value
                state[".".join(path + (names[key],))] = torch.from_numpy(np.array(array))

    walk(flax_params, ())
    state["lm_head.weight"] = state["transformer.wte.weight"]
    return state


def _data(n, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(SEQ // 2, SEQ + 1, size=(n, 1))
    return {"input_ids": rng.integers(1, VOCAB, size=(n, SEQ)).astype(np.int32),
            "attention_mask": (np.arange(SEQ)[None, :] < lengths).astype(np.int32)}


@pytest.fixture(scope="module")
def gpt2():
    transformers = pytest.importorskip("transformers")
    import jax
    import jax.numpy as jnp

    from kronfluence_tpu.prepare import prepare_model as jax_prepare

    from tests.test_hf_flax import GPT2Task
    from tests.testable_tasks.parity import jax_stages, torch_stages

    config = transformers.GPT2Config(
        vocab_size=VOCAB, n_positions=SEQ, n_embd=16, n_layer=2, n_head=2,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    hf = transformers.FlaxGPT2LMHeadModel(config, seed=0, dtype=jnp.float64)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), hf.params)
    config._attn_implementation = "eager"
    module = transformers.GPT2LMHeadModel(config).double()
    missing, unexpected = module.load_state_dict(
        _torch_state_dict(jax.tree_util.tree_map(np.asarray, params)), strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    train, query = _data(NUM_TRAIN, seed=0), _data(NUM_QUERY, seed=1)
    jtask, task = GPT2Task(), TorchGPT2Task()
    model = prepare_model(module, task)
    return dict(
        hf=hf, params=params, model=model, train=train,
        want=jax_stages(jax_prepare(hf.module, jtask), params, jtask, train, query, BATCH,
                        QUERY_BATCH),
        got=torch_stages(model, task, train, query, BATCH, QUERY_BATCH),
    )


def test_gpt2_conv1d_modules_are_tracked(gpt2):
    """8 Conv1D modules (c_attn, c_proj, c_fc, mlp c_proj in 2 layers) and
    the head, under the flax paths' names."""
    tracked = gpt2["model"].tracked_modules()
    assert len(tracked) == 9 and "lm_head" in tracked
    conv = [name for name, m in tracked.items() if is_hf_conv1d(m)]
    assert len(conv) == 8 and "transformer/h/0/attn/c_attn" in conv


def test_gpt2_forward_matches_flax(gpt2):
    b = gpt2["train"]
    position_ids = np.cumsum(b["attention_mask"], axis=1) - 1
    want = np.asarray(gpt2["hf"](b["input_ids"], b["attention_mask"], position_ids,
                                 params=gpt2["params"]).logits)
    with torch.no_grad():
        got = gpt2["model"].module(
            torch.from_numpy(b["input_ids"]), attention_mask=torch.from_numpy(b["attention_mask"]),
            position_ids=torch.from_numpy(position_ids)).logits.numpy()
    valid = b["attention_mask"].astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-10, atol=1e-10)


def test_gpt2_factors_match(gpt2):
    from kronfluence_tpu_torch.utils.constants import ACTIVATION_COVARIANCE_MATRIX_NAME

    from tests.testable_tasks.parity import assert_factors_match

    names = sorted(gpt2["want"][0][ACTIVATION_COVARIANCE_MATRIX_NAME])
    assert len(names) == 9
    assert_factors_match(gpt2["got"][0], gpt2["want"][0], names)


def test_gpt2_scores_match(gpt2):
    from tests.testable_tasks.parity import assert_scores_match

    assert_scores_match(gpt2["got"][1], gpt2["want"][1], (NUM_QUERY, NUM_TRAIN))
    assert_scores_match(gpt2["got"][2], gpt2["want"][2], (NUM_TRAIN,))
