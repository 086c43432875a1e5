"""The port's Q-Former LM and caption decoding (models/lm.py) against
sprc_tpu.models.lm.

A tiny decoder Q-Former (vocabulary 64, hidden 128, 2 layers, 2 heads,
4 queries over 48-wide image rows) is initialised in JAX and carried across
with ``interop.jax_params.qformer_lm_from_jax``; its LM head's decoder is
scaled by 40 so that the decoded tokens win by margins far above fp32's
rounding (checked along JAX's own tokens). Held: the logits within 1e-5 of
their largest magnitude; greedy and beam ids equal to JAX's; the KV-cached
decodes equal the recomputing ones; and ``generate_captions`` on
test_torch_model.py's tiny CIR model gives JAX's text (3 beams).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import qformer_lm_from_jax  # noqa: E402
from sprc_tpu_torch.models import lm  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormerConfig  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

QF = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
          encoder_width=48, query_length=4)
B, Q, S_IMG = 3, 4, 7
IDS = dict(bos_token_id=1, eos_token_id=2, pad_token_id=0)
DECODE = dict(max_length=12, min_length=4)
SCALE = 40.0


@pytest.fixture(scope="module")
def pair():
    """(JAX QFormerLM, its params, the port's QFormerLM, queries, image rows)."""
    from sprc_tpu.models.lm import QFormerLM as JQFormerLM
    from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig

    jlm = JQFormerLM(JQFormerConfig(**QF, dropout_rate=0.0, attention_dropout_rate=0.0))
    rng = np.random.RandomState(0)
    queries = rng.randn(B, Q, 128).astype(np.float32)
    image = rng.randn(B, S_IMG, 48).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: jlm.init(
        k, jnp.zeros((B, 5), jnp.int32), queries, None, image))(jax.random.PRNGKey(0))["params"])
    params["lm_head"]["decoder"]["kernel"] = params["lm_head"]["decoder"]["kernel"] * SCALE
    port = lm.QFormerLM(QFormerConfig(**QF, dropout_rate=0.0))
    port.load_state_dict(qformer_lm_from_jax(params), strict=True)
    return jlm, params, port.eval(), queries, image


def test_logits_equal_jax(pair):
    jlm, params, port, queries, image = pair
    ids = np.random.RandomState(1).randint(3, 64, (B, 9)).astype(np.int32)
    want = np.asarray(jlm.apply({"params": params}, ids, queries, None, image))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(queries),
                   image_embeds=torch.from_numpy(image)).numpy()
    assert got.shape == want.shape == (B, 9, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _min_margin(jlm, params, queries, image, ids):
    """The smallest top-two logit margin of every decoded step along ``ids``
    (JAX's tokens), from JAX's logits."""
    logits = np.asarray(jlm.apply({"params": params}, ids, queries, None, image), np.float64)
    top2 = np.sort(logits[:, :-1], axis=-1)[..., -2:]
    live = np.asarray(ids)[:, 1:] != IDS["pad_token_id"]
    return float((top2[..., 1] - top2[..., 0])[live].min())


@pytest.mark.parametrize("beams", [1, 3])
def test_decodes_equal_jax_and_cached_equals_recompute(pair, beams):
    from sprc_tpu.models import lm as jlm_mod

    jlm, params, port, queries, image = pair
    jfn = jlm_mod.greedy_generate if beams == 1 else jlm_mod.beam_generate
    kw = {} if beams == 1 else {"num_beams": beams}
    want = np.asarray(jfn(jlm, params, jnp.asarray(queries), jnp.asarray(image), **IDS,
                          **DECODE, **kw))
    assert _min_margin(jlm, params, queries, image, want) > 1e-5
    q, img = torch.from_numpy(queries), torch.from_numpy(image)
    fn = lm.greedy_generate if beams == 1 else lm.beam_generate
    cached = lm.cached_greedy_generate if beams == 1 else lm.cached_beam_generate
    got = fn(port, q, img, **IDS, **DECODE, **kw)
    assert got.shape == (B, DECODE["max_length"])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cached(port, q, img, **IDS, **DECODE, **kw).numpy(), want)
    jcached = jlm_mod.cached_greedy_generate if beams == 1 else jlm_mod.cached_beam_generate
    np.testing.assert_array_equal(np.asarray(jcached(
        jlm, params, jnp.asarray(queries), jnp.asarray(image), **IDS, **DECODE, **kw)), want)
    assert (want[:, 1:DECODE["min_length"]] != IDS["eos_token_id"]).all()


class IdTokens:
    """The caption decode's tokenizer surface over raw ids."""

    bos_id, sep_id, pad_id = 1, 2, 0

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids if int(i) not in (0, 1, 2))


def test_generate_captions_equal_jax():
    from sprc_tpu.models.lm import QFormerLMHead as JQFormerLMHead
    from sprc_tpu.models.lm import generate_captions as jgenerate
    from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig

    from sprc_tpu_torch.interop.jax_params import state_dict_from_jax
    from test_torch_model import IMG, VOCAB, jax_model, jax_params, port_model

    jmodel = jax_model()
    params = jax_params(jmodel)
    qcfg = JQFormerConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
                          intermediate_size=256, encoder_width=128, query_length=4)
    head = jax.tree_util.tree_map(np.asarray, JQFormerLMHead(qcfg).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 128)))["params"])
    head["decoder"]["kernel"] = head["decoder"]["kernel"] * SCALE
    port = port_model(state_dict_from_jax(params))
    port_head = lm.QFormerLMHead(port.qformer.cfg)
    port_head.load_state_dict({k[len("cls."):]: v for k, v in qformer_lm_from_jax(
        {"qformer": params["qformer"], "lm_head": head}).items() if k.startswith("cls.")},
        strict=True)
    images = np.random.RandomState(6).rand(2, IMG, IMG, 3).astype(np.float32)
    want = jgenerate(jmodel, params, head, jnp.asarray(images), IdTokens(), max_length=10,
                     min_length=3)  # 3 beams, the default of both
    stats = {}
    got = lm.generate_captions(port, port_head, torch.from_numpy(images), IdTokens(),
                               max_length=10, min_length=3, stats=stats)
    assert got == want and all(got)
    assert set(stats) == {"tower_s", "decode_s"}


def test_qformer_lm_state_from_torch_reads_a_lavis_head():
    """A LAVIS ``Qformer.`` state dict (the tied ``cls.predictions.bias``
    beside the decoder's) loads strictly; a file with only the tied bias
    gives it to the decoder."""
    port = lm.QFormerLM(QFormerConfig(**QF))
    src = {f"Qformer.{k}": torch.randn(v.shape) if v.is_floating_point() else v
           for k, v in port.state_dict().items()}
    src["Qformer.cls.predictions.bias"] = src["Qformer.cls.predictions.decoder.bias"]
    src["visual_encoder.cls_token"] = torch.zeros(1)
    port.load_state_dict(lm.qformer_lm_state_from_torch(src), strict=True)
    assert torch.equal(port.cls.predictions.decoder.bias,
                       src["Qformer.cls.predictions.decoder.bias"])
    only_tied = dict(src)
    bias = only_tied.pop("Qformer.cls.predictions.decoder.bias") + 1
    only_tied["Qformer.cls.predictions.bias"] = bias
    port.load_state_dict(lm.qformer_lm_state_from_torch(only_tied), strict=True)
    assert torch.equal(port.cls.predictions.decoder.bias, bias)
