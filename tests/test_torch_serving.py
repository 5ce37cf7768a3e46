"""Batched serving in the port against the JAX package, on the same
weights: forced-ragged ``generate_batch`` (the decode step through the
ragged decode attention on both sides) and ``ServingEngine`` (bucket
grouping, chunks of ``max_batch_size``, results in submission order).

Float32 configs on both sides, so the comparison is of the algorithm.
"""

import numpy as np
import pytest
import torch

import seedx_tpu.models.decode_stacked
import seedx_tpu.ops.int4_matmul
from seedx_tpu.inference.serving import ServingEngine as JaxServingEngine
from seedx_tpu.models import generation as jgen
from seedx_tpu.text.tokenizer import load_tokenizer as jload_tokenizer
import seedx_tpu_torch.models.llama
from seedx_tpu_torch.inference.runtime import SeedXRuntime as TorchRuntime
from seedx_tpu_torch.inference.serving import ServingEngine
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.text.tokenizer import load_tokenizer
from seedx_tpu_torch.utils.convert import load_jax_params
from test_torch_slice import (_f32_jax_runtime, _image, _numpy_tree,
                              _tiny_int4_agents)

torch.set_num_threads(1)


def counting(monkeypatch, module, name):
    """Replace ``module.name`` by a wrapper that counts its calls."""
    calls = []
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_forced_ragged_generate_batch_matches_jax(monkeypatch):
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    jcalls = counting(monkeypatch, seedx_tpu.models.decode_stacked,
                      "ragged_decode_attention")
    tcalls = counting(monkeypatch, seedx_tpu_torch.models.llama,
                      "ragged_decode_attention")
    model_j, vars_j, agent_t = _tiny_int4_agents(ragged=True)
    tok_j, tok = jload_tokenizer(), load_tokenizer()
    texts = ["hi", "the cat sat on the mat", "one two three four five six"]
    reqs = [{"input_ids": [tok.bos_token_id] + tok.encode(t)} for t in texts]
    assert len({len(r["input_ids"]) for r in reqs}) == 3   # left-padded
    # cache length 56 + 8 = 64: the JAX dispatch reads it as one 64-row
    # tile (decode_stacked.py:122-136), so its softmax maximum is the
    # window's, as in the port's plain version, and p rounds to bf16 alike.
    # (At 128 + 8 its 8-row tiles round p against running maxima: logits
    # then move by ~2^-8 relative and near-ties of the random weights flip.)
    gen_j = jgen.GenerationConfig(max_new_tokens=8, prompt_buckets=(56,))
    gen_t = tgen.GenerationConfig(max_new_tokens=8, prompt_buckets=(56,))
    out_j = jgen.generate_batch(model_j, vars_j, tok_j, reqs, gen_cfg=gen_j)
    timings = {}
    out_t = tgen.generate_batch(agent_t, tok, reqs, gen_cfg=gen_t,
                                timings=timings)
    # both decode loops went through the ragged attention: JAX traces it
    # into its decode loop, the port calls it per layer and step
    assert len(jcalls) > 0
    assert timings["decode_forwards"] > 0
    assert len(tcalls) == 2 * timings["decode_forwards"]
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a["tokens"], np.asarray(b["tokens"]))
        assert a["text"] == b["text"]


def test_serving_engine_matches_jax():
    rt_j = _f32_jax_runtime()
    rt_t = TorchRuntime.debug(dtype=torch.float32, device="cpu")
    load_jax_params(rt_t.vit, _numpy_tree(rt_j.vit_params))
    load_jax_params(rt_t.agent, _numpy_tree(rt_j.agent_params))
    tok = rt_t.tokenizer
    images = [_image(56, 56, 1), _image(56, 112, 2)]   # 2 and 3 patches
    raw = [[tok.bos_token_id] + tok.encode(t) for t in ("hello", "abc abc")]

    outs = {}
    for name, rt, cls in (("jax", rt_j, JaxServingEngine),
                          ("port", rt_t, ServingEngine)):
        eng = cls(rt, max_batch_size=2, max_new_tokens=4)
        order = [eng.submit_raw({"input_ids": raw[0]}),
                 eng.submit_comprehend(images[0], "What is this?"),
                 eng.submit_raw({"input_ids": raw[1]}),
                 eng.submit_comprehend(images[1], "Where?")]
        assert order == [0, 1, 2, 3]
        groups = {}
        for p in eng._pending:
            n = len(p.request["input_ids"])
            groups.setdefault(next(b for b in (128, 256, 512, 1024)
                                   if b >= n), []).append(p.idx)
        assert groups == {128: [0, 2], 256: [1, 3]}   # two buckets of two
        outs[name] = eng.flush()
        assert eng.flush() == []
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a["tokens"], np.asarray(b["tokens"]))
        assert a["text"] == b["text"]
        assert a["clean_text"] == b["clean_text"]
        assert a["images"] is None and b["images"] is None
