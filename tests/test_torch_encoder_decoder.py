"""The port's encoder-decoder (models/encoder_decoder.py) through the four
stages and both score kinds against the JAX package's EncDecLM on the CPU in
fp64, with a half-masked encoder and the dict attention masks of
tests/test_misc_features.py:196: the same flax weights (models/convert.py),
the same tokens from a numpy seed. Encoder modules count the unmasked
encoder tokens, decoder modules every decoder token, the cross-attention's
keys and values the encoder's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import torch.nn.functional as F

from kronfluence_tpu.models.encoder_decoder import EncDecConfig as JaxEncDecConfig
from kronfluence_tpu.models.encoder_decoder import EncDecLM as JaxEncDecLM
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu_torch.models.convert import state_dict_from_flax
from kronfluence_tpu_torch.models.encoder_decoder import EncDecConfig, EncDecLM, init_encdec
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
)

from tests.test_misc_features import Seq2SeqTask
from tests.testable_tasks.parity import (
    assert_factors_match,
    assert_scores_match,
    jax_stages,
    torch_stages,
)

NUM_TRAIN, BATCH, NUM_QUERY, QUERY_BATCH = 6, 3, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


class TorchSeq2SeqTask(Task):
    """Torch twin of tests/test_misc_features.py:Seq2SeqTask."""

    def __init__(self, num_layers: int = 2):
        self.num_layers = num_layers

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = model(batch["input_ids"], batch["decoder_input_ids"], batch["attention_mask"],
                       batch["decoder_attention_mask"])[:, :-1]
        mask = batch["decoder_attention_mask"][:, 1:].to(logits.dtype)
        vocab = logits.shape[-1]
        if sample:
            probs = torch.softmax(logits.detach().reshape(-1, vocab), dim=-1)
            labels = torch.multinomial(probs, 1, generator=generator).reshape(mask.shape)
        else:
            labels = batch["decoder_input_ids"][:, 1:].long()
        losses = F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1),
                                 reduction="none").reshape(mask.shape)
        return torch.sum(losses * mask)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)

    def get_attention_mask(self, batch):
        enc, dec = batch["attention_mask"], batch["decoder_attention_mask"]
        masks = {}
        for i in range(self.num_layers):
            for sub in ("attn/q", "attn/k", "attn/v", "attn/o", "mlp/wi", "mlp/wo"):
                masks[f"encoder_{i}/{sub}"] = enc
            for sub in ("self_attn/q", "self_attn/k", "self_attn/v", "self_attn/o",
                        "cross_attn/q", "cross_attn/o", "mlp/wi", "mlp/wo"):
                masks[f"decoder_{i}/{sub}"] = dec
            for sub in ("cross_attn/k", "cross_attn/v"):
                masks[f"decoder_{i}/{sub}"] = enc
        masks["lm_head"] = dec
        return masks


def seq2seq_data(n, t, vocab, seed):
    """tests/test_misc_features.py:206-216's data: every encoder sequence
    half-length, the decoder unmasked."""
    rng = np.random.default_rng(seed)
    enc_mask = np.ones((n, t), dtype=np.int32)
    enc_mask[:, t // 2:] = 0
    return {
        "input_ids": rng.integers(1, vocab, size=(n, t)).astype(np.int32) * enc_mask,
        "decoder_input_ids": rng.integers(1, vocab, size=(n, t)).astype(np.int32),
        "attention_mask": enc_mask,
        "decoder_attention_mask": np.ones((n, t), dtype=np.int32),
    }


@pytest.fixture(scope="module")
def run():
    jconfig = JaxEncDecConfig(dtype=jnp.float64, param_dtype=jnp.float64)
    flax_module = JaxEncDecLM(jconfig)
    ids = jnp.zeros((1, jconfig.max_seq_len), jnp.int32)
    params = flax_module.init(jax.random.PRNGKey(0), ids, ids)["params"]
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.float64), params)
    module = EncDecLM(EncDecConfig(dtype=torch.float64))
    module.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                module))
    t, vocab = jconfig.max_seq_len, jconfig.vocab_size
    train = seq2seq_data(NUM_TRAIN, t, vocab, seed=0)
    query = seq2seq_data(NUM_QUERY, t, vocab, seed=1)
    jtask, task = Seq2SeqTask(), TorchSeq2SeqTask()
    want = jax_stages(jax_prepare(flax_module, jtask), params, jtask, train, query, BATCH,
                      QUERY_BATCH)
    got = torch_stages(prepare_model(module, task), task, train, query, BATCH, QUERY_BATCH)
    return dict(flax_module=flax_module, params=params, module=module, train=train, want=want,
                got=got)


def test_forward_matches_flax(run):
    """Decoder logits at the valid decoder positions."""
    b = run["train"]
    args = [b["input_ids"], b["decoder_input_ids"], b["attention_mask"],
            b["decoder_attention_mask"]]
    want = np.asarray(run["flax_module"].apply({"params": run["params"]}, *args))
    with torch.no_grad():
        got = run["module"](*[torch.from_numpy(a) for a in args]).numpy()
    valid = b["decoder_attention_mask"].astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-10, atol=1e-10)


def test_factors_match(run):
    names = sorted(run["want"][0][ACTIVATION_COVARIANCE_MATRIX_NAME])
    assert len(names) == 2 * 6 + 2 * 10 + 1  # encoder q k v o wi wo, decoder 10, lm_head
    assert_factors_match(run["got"][0], run["want"][0], names)


def test_pairwise_scores_match(run):
    assert_scores_match(run["got"][1], run["want"][1], (NUM_QUERY, NUM_TRAIN))


def test_self_scores_match(run):
    assert_scores_match(run["got"][2], run["want"][2], (NUM_TRAIN,))


@pytest.mark.parametrize("count", [NUM_ACTIVATION_COVARIANCE_PROCESSED,
                                   NUM_GRADIENT_COVARIANCE_PROCESSED])
def test_token_counts_follow_the_dict_masks(run, count):
    counts = {n: int(c[0]) for n, c in run["got"][0][count].items()}
    enc, dec = (int(run["train"][k].sum()) for k in ("attention_mask", "decoder_attention_mask"))
    assert enc == NUM_TRAIN * 16 and dec == NUM_TRAIN * 32
    assert counts["encoder_0/attn/q"] == counts["encoder_1/mlp/wo"] == enc
    assert counts["decoder_0/self_attn/q"] == counts["decoder_1/cross_attn/o"] == dec
    assert counts["decoder_0/cross_attn/k"] == counts["decoder_1/cross_attn/v"] == enc
    assert counts["lm_head"] == dec


def test_init_encdec_is_seeded():
    config = EncDecConfig(d_model=16, num_heads=2, num_layers=1, vocab_size=32, max_seq_len=8)
    a, b = init_encdec(config, seed=3, device="cpu"), init_encdec(config, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert float(a.decoder_0.cross_attn.k.weight.detach().std()) > 0.1
