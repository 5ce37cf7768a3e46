"""``LlamaForSequenceClassification`` (``models/llama.py``) against the JAX
package's on the same weights: float32, a right-padded batch and an
unpadded one, logits within 2e-5 of their scale (the LLaMA parity
tolerance of tests/test_torch_models.py).  The JAX tree (``embed_tokens``,
``model`` = trunk + final norm, ``score``) loads through
``utils/convert.load_jax_params`` strictly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.models import llama as jllama
from seedx_tpu_torch.models import llama as tllama
from seedx_tpu_torch.utils.convert import load_jax_params

from test_torch_models import randomize

torch.set_num_threads(1)

KW = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=4)


@pytest.fixture(scope="module")
def models():
    cfg_j = jllama.llama_debug(dtype=jnp.float32, **KW)
    model_j = jllama.LlamaForSequenceClassification(cfg_j, num_labels=3)
    params = randomize(model_j.init(jax.random.PRNGKey(0),
                                    jnp.zeros((2, 8), jnp.int32))["params"],
                       6)
    model_t = load_jax_params(tllama.LlamaForSequenceClassification(
        tllama.llama_debug(dtype=torch.float32, **KW), num_labels=3).eval(),
        params)
    return model_j, params, model_t


@pytest.mark.parametrize("padded", [True, False])
def test_sequence_classification_matches_jax(models, padded):
    model_j, params, model_t = models
    rng = np.random.default_rng(7 + padded)
    b, s = 3, 10
    ids = rng.integers(3, 500, (b, s))
    mask = np.ones((b, s), bool)
    if padded:
        mask[1, 6:] = False
        mask[2, 2:] = False
        ids = np.where(mask, ids, 0)
    want = model_j.apply({"params": params}, jnp.asarray(ids),
                         jnp.asarray(mask) if padded else None)
    with torch.no_grad():
        got = model_t(torch.from_numpy(ids),
                      torch.from_numpy(mask) if padded else None)
    assert got.shape == (b, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5 * np.abs(np.asarray(want)).max())
    if padded:
        # the score is the last real token's: pad ids do not move it
        other = np.where(mask, ids, 7)
        with torch.no_grad():
            again = model_t(torch.from_numpy(other), torch.from_numpy(mask))
        np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                                   atol=1e-6)
