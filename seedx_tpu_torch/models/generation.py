"""Multimodal generation: prefill + decode loop (reference:
seedx_tpu/models/generation.py; src/models/mllm/seed_x.py:130-223).

Prompts are left-padded into length buckets; one prefill writes a
preallocated KV cache, then the decode loop follows the JAX package's
``_run_decode_loop``: its state lives in static device buffers
(``DecodeState``) and one predicated step (``decode_step``) decodes one
token, a no-op once decode has stopped (``n == t`` or every row emitted
EOS) or sits at a chunkable ``<img>``.  On the card that step is one
captured CUDA graph (``utils/graphs.py``), replayed; the host reads a
flag tensor once every ``CHECK_EVERY`` steps, not every token, and
sampling's random draws are made on the host's side of a window and the
unused ones given back (``SampleNoise``), so a seeded stream advances one
draw a sampled token.  ``generate_tokens`` keeps its decode states with
the agent (``DecodePrograms``: one a shape, their KV caches views of one
storage); a chat session keeps its own.  Each
decode step's kv mask is one contiguous window per row (left pad to the
newest token), built on the device from ``n``, so the step reads only
that window through the ragged decode kernel
(``LlamaConfig.decode_attention``).  ``constrain_image_tokens``,
``_sample``, ``_trim_and_spans`` and ``build_result`` are shared with the
continuous engine (inference/continuous.py).  The constrained image-token
decoder forces ``<img_00000>..<img_(n-1)></img>`` once ``<img>`` is
emitted; when every live row sits at ``<img>``, that forced span runs as
one (n+1)-token forward into the cache (the "chunk", an eager forward at
exactly the ``n`` the JAX loop fires it at), whose hidden states feed the
output resampler.  ``generate_tokens_cached`` (multi-turn chat) prefills
only a prompt's new suffix into a persistent cache and runs the same
decode loop.  Speculative decoding, ``script_ids`` and beam search are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from seedx_tpu_torch.models.agent import ContinuousLVLM, positions_from_mask
from seedx_tpu_torch.models.llama import init_kv_cache
from seedx_tpu_torch.text.vocab import DEFAULT_VOCAB, MultimodalVocab
from seedx_tpu_torch.utils.graphs import CHECK_EVERY, Graphs, Program


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 512
    num_img_gen_tokens: int = 64
    do_sample: bool = False
    temperature: float = 0.7
    top_p: float = 0.5
    eos_token_id: int = 2
    pad_token_id: int = 0
    prompt_buckets: tuple = (128, 256, 512, 1024)


def constrain_image_tokens(prev_token: torch.Tensor, logits: torch.Tensor,
                           vocab: MultimodalVocab, num_img_gen_tokens: int
                           ) -> torch.Tensor:
    """AutoImageTokenGenerationProcessor as tensor arithmetic (reference
    generation.py:80-116).  prev_token [B]; logits [B, V] fp32.

    Forced continuation: <img> -> img_0, img_k -> img_{k+1}, img_{n-1} ->
    </img>; the forced id gets max + 10 and every other id -1e9.  Unforced:
    the image continuation ids and </img> get score 0.0."""
    img0 = vocab.img_token_start
    n = num_img_gen_tokens
    forced = torch.where(
        prev_token == vocab.boi, img0,
        torch.where((prev_token >= img0) & (prev_token < img0 + n - 1),
                    prev_token + 1,
                    torch.where(prev_token == img0 + n - 1, vocab.eoi, -1)))
    is_forced = forced >= 0
    v = logits.shape[-1]
    ids = torch.arange(v, device=logits.device)
    zero_ids = ((ids >= img0) & (ids < img0 + n)) | (ids == vocab.eoi)
    unforced = torch.where(zero_ids[None, :], 0.0, logits)
    win = logits.amax(dim=-1, keepdim=True) + 10.0
    onehot = ids[None, :] == torch.clamp(forced, min=0)[:, None]
    forced_logits = torch.where(onehot, win, torch.full_like(logits, -1e9))
    return torch.where(is_forced[:, None], forced_logits, unforced)


def _sample(logits: torch.Tensor, cfg: GenerationConfig,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy argmax, or temperature + top-p sampling: from ``generator``
    (``torch.multinomial``), or, given ``noise`` (Exp(1) draws over the
    logits' shape), ``argmax(probs / noise)``, the rule by which
    ``torch.multinomial`` draws one sample (so the same token, given the
    draws it would make)."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    filtered = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(filtered, dim=-1)
    if noise is not None:
        return torch.argmax(probs / noise, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def default_generator(device) -> torch.Generator:
    """The generator ``torch.multinomial`` uses on ``device`` when given
    none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        return torch.cuda.default_generators[index]
    return torch.default_generator


class SampleNoise:
    """``_sample``'s random draws for a run of up to ``k`` steps, made
    outside the steps (so no generator runs inside a captured program):
    ``draw`` fills ``buf[j]`` with the run's j-th Exp(1) draw before the
    run, a step that samples takes the slot of the sampling steps before
    it in the run (``at``), and ``give_back`` returns the generator to its
    state before the first draw no step took.  The generator so advances
    one draw a sampling step, as the eager loop's ``torch.multinomial``
    calls did, however many of a run's steps were no-ops."""

    def __init__(self, b: int, vocab_size: int, k: int, device):
        self.buf = torch.ones((k, b, vocab_size), dtype=torch.float32,
                              device=device)
        self.generator: Optional[torch.Generator] = None
        self._states: list = []

    def draw(self, generator: torch.Generator, steps: int) -> None:
        self.generator = generator
        self._states = []
        for j in range(steps):
            self._states.append(generator.get_state())
            self.buf[j].exponential_(generator=generator)

    def give_back(self, used: int) -> None:
        if used < len(self._states):
            self.generator.set_state(self._states[used])
        self._states = []

    def at(self, i: torch.Tensor) -> torch.Tensor:
        """The draws of the step with ``i`` (a 0-d device tensor) sampling
        steps before it in the run."""
        k = self.buf.shape[0]
        return self.buf.index_select(0, torch.clamp(i, max=k - 1).view(1))[0]


@torch.no_grad()
def generate_tokens(model: ContinuousLVLM, prompt_embeds: torch.Tensor,
                    prompt_mask: torch.Tensor,
                    last_prompt_token: torch.Tensor,
                    gen_cfg: GenerationConfig,
                    vocab: MultimodalVocab = DEFAULT_VOCAB,
                    generator: Optional[torch.Generator] = None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> Dict[str, torch.Tensor]:
    """prompt_embeds [B, P, D] (image embeds spliced), prompt_mask [B, P]
    bool LEFT-padded, last_prompt_token [B] -> {tokens [B, T], hidden
    [B, T, D], finished [B, T]}; hidden[:, i] is the state that produced
    tokens[:, i] (reference alignment, seed_x.py:196-207).

    ``timings``, when given, receives host seconds for "prefill" and
    "decode" (each closed by a device synchronize), the decode forwards
    in "decode_forwards" and the tokens they emitted in "decode_tokens".
    With the agent's graphs on, the KV cache and the captured decode step
    of a shape are kept by the agent (``DecodePrograms``)."""
    b, p, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    t = gen_cfg.max_new_tokens
    if model.graphs.active(dev):
        st = decode_programs(model).state(model, b, p + t, gen_cfg, vocab,
                                          dev)
    else:
        st = DecodeState(model, init_kv_cache(model.cfg.llm, b, p + t,
                                              device=dev),
                         b, gen_cfg, vocab, None)

    clock = PhaseClock(dev, timings)
    positions = positions_from_mask(prompt_mask)
    kv_valid = torch.cat([prompt_mask,
                          torch.zeros((b, t), dtype=torch.bool, device=dev)],
                         dim=-1)
    logits, hidden, _ = model.llm_step(prompt_embeds, positions, kv_valid,
                                       st.cache, 0)
    clock.mark("prefill")
    out, steps, n = _decode_loop(
        model, st, kv_valid, p, logits[:, -1].float(), hidden[:, -1],
        positions[:, -1], last_prompt_token.to(dev, torch.int64), gen_cfg,
        vocab, generator)
    clock.mark("decode")
    if timings is not None:
        timings["decode_forwards"] = steps
        timings["decode_tokens"] = n
    return out


class DecodeState:
    """The decode loop's state as static device buffers, updated in place
    by ``decode_step`` (the state tuple of the JAX package's
    ``_run_decode_loop``): the tokens decoded ``n`` and the forwards run,
    each row's ``finished`` flag, previous token, logits, hidden state and
    position, the outputs, the kv mask of the prompt (``prefix_valid``),
    the first generated position ``base`` and the sampling steps of the
    current check window (``drawn``, the slot of ``noise``, the window's
    draws when ``gen_cfg`` samples); ``flags`` [5] int64 (stop, at a
    chunkable ``<img>``, n, forwards, drawn) is what the host reads.  Its
    ``program`` is the one-token step over these buffers and the KV
    ``cache``, captured while ``graphs`` is on (None: always eager)."""

    def __init__(self, model: ContinuousLVLM, cache, b: int,
                 gen_cfg: GenerationConfig, vocab: MultimodalVocab,
                 graphs: Optional[Graphs]):
        cfg = model.cfg.llm
        dev = cache[0].device
        t = gen_cfg.max_new_tokens
        i64 = dict(dtype=torch.int64, device=dev)
        self.cache, self.gen_cfg = cache, gen_cfg
        self.n = torch.zeros((), **i64)
        self.forwards = torch.zeros((), **i64)
        self.drawn = torch.zeros((), **i64)
        self.base = torch.zeros((), **i64)
        self.flags = torch.zeros((5,), **i64)
        self.prefix_valid = torch.zeros((b, cache[0].shape[2]),
                                        dtype=torch.bool, device=dev)
        self.finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.prev_token = torch.zeros((b,), **i64)
        self.prev_logits = torch.zeros((b, cfg.vocab_size),
                                       dtype=torch.float32, device=dev)
        self.prev_hidden = torch.zeros((b, cfg.hidden_size), dtype=cfg.dtype,
                                       device=dev)
        self.prev_pos = torch.zeros((b,), **i64)
        self.out_tokens = torch.zeros((b, t), **i64)
        self.out_hidden = torch.zeros((b, t, cfg.hidden_size),
                                      dtype=cfg.dtype, device=dev)
        self.out_finished = torch.zeros((b, t), dtype=torch.bool, device=dev)
        self.noise = (SampleNoise(b, cfg.vocab_size, CHECK_EVERY, dev)
                      if gen_cfg.do_sample else None)
        self.program = Program(
            lambda: decode_step(model, self, gen_cfg, vocab), dev, graphs)

    def reset(self, prefix_valid, base: int, prev_logits, prev_hidden,
              prev_pos, prev_token, gen_cfg: GenerationConfig,
              vocab: MultimodalVocab) -> None:
        self.prefix_valid.copy_(prefix_valid)
        self.base.fill_(base)
        self.n.zero_()
        self.forwards.zero_()
        self.drawn.zero_()
        self.finished.zero_()
        self.prev_token.copy_(prev_token)
        self.prev_logits.copy_(prev_logits)
        self.prev_hidden.copy_(prev_hidden)
        self.prev_pos.copy_(prev_pos)
        self.out_tokens.fill_(gen_cfg.pad_token_id)
        self.out_hidden.zero_()
        self.out_finished.zero_()
        self.set_flags(gen_cfg, vocab)

    def stop_and_chunk(self, gen_cfg: GenerationConfig,
                       vocab: MultimodalVocab):
        """(stop, at a chunkable <img>) as 0-d bool tensors: decode ends
        at ``n == t`` or once every row finished (JAX ``cond``); the forced
        chunk fires when every live row sits at ``<img>`` with room for
        the span (``at_chunkable_img``, generation.py:445-452)."""
        t = gen_cfg.max_new_tokens
        stop = (self.n >= t) | self.finished.all()
        chunk = (((self.prev_token == vocab.boi) & ~self.finished).all()
                 & (self.n + gen_cfg.num_img_gen_tokens + 1 <= t))
        return stop, chunk

    def set_flags(self, gen_cfg: GenerationConfig,
                  vocab: MultimodalVocab) -> None:
        stop, chunk = self.stop_and_chunk(gen_cfg, vocab)
        self.flags.copy_(torch.stack([stop.long(), chunk.long(), self.n,
                                      self.forwards, self.drawn]))


def _put_col(buf: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
             live: torch.Tensor) -> None:
    """buf[:, col] = val where ``live`` (0-d), else left as it was."""
    cur = buf.index_select(1, col)[:, 0]
    buf.index_copy_(1, col, torch.where(live, val, cur)[:, None])


@torch.no_grad()
def decode_step(model: ContinuousLVLM, st: DecodeState,
                gen_cfg: GenerationConfig, vocab: MultimodalVocab) -> None:
    """One predicated decode step on ``st`` in place (JAX
    ``single_step``): sample token n from the previous logits under the
    image-token constraint, record it, run it through the model at cache
    position ``base + n``.  The step is a no-op (no output, counter or
    live cache cell changes; its forward still runs, with its cache
    writes masked) when decode has stopped or sits at a chunkable
    ``<img>``: a replayed program runs it regardless."""
    b, t = st.out_tokens.shape
    n_img = gen_cfg.num_img_gen_tokens
    c = st.cache[0].shape[2]
    stop, chunk = st.stop_and_chunk(gen_cfg, vocab)
    live = ~(stop | chunk)
    constrained = constrain_image_tokens(st.prev_token, st.prev_logits, vocab,
                                         n_img)
    noise = None if st.noise is None else st.noise.at(st.drawn)
    token = _sample(constrained, gen_cfg, noise=noise)
    token = torch.where(st.finished, gen_cfg.pad_token_id, token)
    finished = st.finished | (token == gen_cfg.eos_token_id)
    col = torch.clamp(st.n, max=t - 1).view(1)
    _put_col(st.out_tokens, col, token, live)
    _put_col(st.out_hidden, col, st.prev_hidden, live)
    _put_col(st.out_finished, col, finished, live)
    pos = st.prev_pos + 1
    at = st.base + st.n
    span = torch.arange(c, device=token.device)
    kv_valid = st.prefix_valid | ((span >= st.base) & (span <= at))[None]
    # at n == t the write index is past the cache: clamped, and masked,
    # so it puts back what the last real token's cell holds
    logits, hidden, _ = model.llm_step(
        model.embed_ids(token[:, None]), pos[:, None], kv_valid, st.cache,
        torch.clamp(at, max=c - 1).expand(b), write_mask=live.expand(b))
    st.prev_logits.copy_(torch.where(live, logits[:, 0].float(),
                                     st.prev_logits))
    st.prev_hidden.copy_(torch.where(live, hidden[:, 0], st.prev_hidden))
    st.prev_pos.copy_(torch.where(live, pos, st.prev_pos))
    st.prev_token.copy_(torch.where(live, token, st.prev_token))
    st.finished.copy_(torch.where(live, finished, st.finished))
    st.n.add_(live.long())
    st.forwards.add_(live.long())
    st.drawn.add_(live.long())
    st.set_flags(gen_cfg, vocab)


@torch.no_grad()
def _image_chunk(model: ContinuousLVLM, st: DecodeState, base: int, n: int,
                 gen_cfg: GenerationConfig, vocab: MultimodalVocab) -> None:
    """The forced ``<img_00000>..</img>`` span as one (n_img + 1)-token
    forward into the cache at ``base + n`` (JAX ``chunk_step``).  It stays
    an eager forward: its attention's causal offset is a host integer."""
    b = st.out_tokens.shape[0]
    dev = st.n.device
    n_img = gen_cfg.num_img_gen_tokens
    c = n_img + 1
    ids = torch.cat([
        torch.arange(vocab.img_token_start, vocab.img_token_start + n_img,
                     device=dev),
        torch.tensor([vocab.eoi], device=dev)])[None, :].expand(b, c)
    pos = st.prev_pos[:, None] + 1 + torch.arange(c, device=dev)[None, :]
    span = torch.arange(st.cache[0].shape[2], device=dev)
    kv_valid = st.prefix_valid | ((span >= base)
                                  & (span < base + n + c))[None]
    logits, hidden, _ = model.llm_step(model.embed_ids(ids), pos, kv_valid,
                                       st.cache, base + n)
    st.out_tokens[:, n:n + c] = ids
    st.out_hidden[:, n] = st.prev_hidden
    st.out_hidden[:, n + 1:n + c] = hidden[:, :n_img]
    st.out_finished[:, n:n + c] = st.finished[:, None]
    st.prev_logits.copy_(logits[:, -1].float())
    st.prev_hidden.copy_(hidden[:, -1])
    st.prev_pos.add_(c)
    st.prev_token.fill_(vocab.eoi)
    st.n.add_(c)
    st.forwards.add_(1)
    st.set_flags(gen_cfg, vocab)


class DecodePrograms:
    """``generate_tokens``' decode states on the card, kept by the agent
    (``decode_programs(model)``), one per shape (batch, cache length,
    generation config), each with its captured step.  Their KV caches are
    views of one storage, sized for the largest shape yet asked for
    (``reserve``): calls run one at a time and a call reads only cache
    cells it wrote, so one storage serves every shape.  Their graphs share
    the agent's graph pool, so what is kept between calls is one KV cache
    of the largest shape, one pool and each shape's small buffers.  A
    shape the storage cannot hold replaces it, and drops every state (its
    graph points at the old storage)."""

    def __init__(self):
        self.states: Dict[tuple, DecodeState] = {}
        self._storage: tuple = ()

    def reserve(self, model: ContinuousLVLM, b: int, length: int,
                dev) -> None:
        """Size the KV storage for ``b`` rows of ``length`` positions."""
        need = [(math.prod(x.shape), x.dtype) for x in
                init_kv_cache(model.cfg.llm, b, length, device="meta")]
        if len(self._storage) == len(need) and all(
                s.numel() >= n and s.dtype == dt
                for s, (n, dt) in zip(self._storage, need)):
            return
        self.states.clear()
        self._storage = ()
        self._storage = tuple(torch.zeros(n, dtype=dt, device=dev)
                              for n, dt in need)

    def state(self, model: ContinuousLVLM, b: int, length: int,
              gen_cfg: GenerationConfig, vocab: MultimodalVocab,
              dev) -> DecodeState:
        key = (b, length, gen_cfg, vocab)
        st = self.states.get(key)
        if st is None:
            self.reserve(model, b, length, dev)
            cache = tuple(
                s[:math.prod(x.shape)].view(x.shape) for s, x in zip(
                    self._storage, init_kv_cache(model.cfg.llm, b, length,
                                                 device="meta")))
            st = DecodeState(model, cache, b, gen_cfg, vocab, model.graphs)
            self.states[key] = st
        return st

    def warm(self, model: ContinuousLVLM, b: int, bucket: int,
             gen_cfg: GenerationConfig, vocab: MultimodalVocab) -> None:
        """Capture ahead of time the decode step ``generate_tokens`` runs
        at batch ``b`` and prompt bucket ``bucket`` (its warm run is on an
        inert state, every row finished: a no-op).  Nothing to do off the
        card or with the agent's graphs off."""
        dev = next(model.buffers()).device
        if not model.graphs.active(dev):
            return
        st = self.state(model, b, bucket + gen_cfg.max_new_tokens, gen_cfg,
                        vocab, dev)
        if st.program.graph is None:
            st.finished.fill_(True)
            st.program()

    def programs(self):
        return [st.program for st in self.states.values()]


def decode_programs(model: ContinuousLVLM) -> DecodePrograms:
    """The agent's ``DecodePrograms`` (made at its first use)."""
    if "decode_programs" not in vars(model):
        model.decode_programs = DecodePrograms()
    return model.decode_programs


def _decode_loop(model: ContinuousLVLM, st: DecodeState, prefix_valid,
                 base: int, prev_logits, prev_hidden, prev_pos, prev_token,
                 gen_cfg: GenerationConfig, vocab: MultimodalVocab,
                 generator: Optional[torch.Generator]):
    """The decode loop shared by ``generate_tokens`` and
    ``generate_tokens_cached``, in the segments of the JAX package's
    ``_run_decode_loop``: windows of ``decode_step`` (one token a forward,
    replayed as one captured program on the card), the host reading the
    flags once a window of ``CHECK_EVERY`` steps (and never stepping past
    ``n == t``), and the forced chunk, an eager forward, at exactly the
    ``n`` where every live row sits at ``<img>``.  Sampling draws a
    window's noise before it and gives back what its no-op steps did not
    take (``SampleNoise``; ``generator`` None: the device's default).
    Output token n is written to cache position ``base + n``;
    ``prefix_valid`` [B, C] is the prompt's kv mask.  Returns (out dict,
    forwards, tokens); the out tensors are the caller's own."""
    t = gen_cfg.max_new_tokens
    st.reset(prefix_valid, base, prev_logits, prev_hidden, prev_pos,
             prev_token, gen_cfg, vocab)
    if st.noise is not None and generator is None:
        generator = default_generator(st.n.device)
    while True:
        stop, chunk, n, forwards, drawn = st.flags.tolist()
        if st.noise is not None:
            st.noise.give_back(drawn)
        if stop:
            break
        if chunk:
            _image_chunk(model, st, base, n, gen_cfg, vocab)
            continue
        steps = min(CHECK_EVERY, t - n)
        st.drawn.zero_()
        if st.noise is not None:
            st.noise.draw(generator, steps)
        for _ in range(steps):
            st.program()
    out = {"tokens": st.out_tokens.clone(), "hidden": st.out_hidden.clone(),
           "finished": st.out_finished.clone()}
    return out, forwards, n


@torch.no_grad()
def generate_tokens_cached(model: ContinuousLVLM, cache, seg_embeds,
                           seg_start: int, seg_len: int,
                           last_prompt_token: int, gen_cfg: GenerationConfig,
                           vocab: MultimodalVocab = DEFAULT_VOCAB,
                           generator: Optional[torch.Generator] = None,
                           timings: Optional[Dict[str, float]] = None,
                           decode: Optional[DecodeState] = None):
    """Prefix-cached single-prompt generation for multi-turn chat
    (reference ``generate_tokens_cached``, generation.py:537-739).

    ``cache`` [L, 1, C, ...] already holds valid KV at positions
    [0, seg_start); ``seg_embeds`` [1, Sb, D] is the prompt's new suffix,
    right-padded, of which ``seg_len`` tokens are real.  Only the suffix
    is prefilled, at ``seg_start``; attending to the cached prefix gives
    what a full prefill would.  Stale KV past ``seg_start + seg_len`` (the
    last turn's reply, re-serialized) is overwritten or masked.  Decode
    then runs ``generate_tokens``' loop, writing at absolute positions so
    the next turn can extend the prefix; a step after the turn's last
    token changes no cell, even where that token sits in the cache's last
    position.  ``decode`` is the caller's decode state over ``cache`` (a
    chat session's, kept with its cache and captured while the agent's
    graphs are on); without it decode runs eagerly.  Returns (out dict,
    cache, seg_start + seg_len + tokens decoded); the cache is updated in
    place.  ``timings`` as in ``generate_tokens``."""
    dev = seg_embeds.device
    c = cache[0].shape[2]
    sb = seg_embeds.shape[1]
    if decode is None:
        decode = DecodeState(model, cache, 1, gen_cfg, vocab, None)
    elif decode.cache is not cache or decode.gen_cfg != gen_cfg:
        raise ValueError("generate_tokens_cached: the decode state is not "
                         "this cache's or this generation config's")
    clock = PhaseClock(dev, timings)
    positions = (seg_start + torch.arange(sb, device=dev))[None]
    kv_valid = (torch.arange(c, device=dev) < seg_start + seg_len)[None]
    logits, hidden, _ = model.llm_step(seg_embeds, positions, kv_valid,
                                       cache, seg_start)
    clock.mark("prefill")
    p_total = seg_start + seg_len
    out, steps, n = _decode_loop(
        model, decode, kv_valid, p_total, logits[:, seg_len - 1].float(),
        hidden[:, seg_len - 1],
        torch.full((1,), p_total - 1, dtype=torch.int64, device=dev),
        torch.full((1,), last_prompt_token, dtype=torch.int64, device=dev),
        gen_cfg, vocab, generator)
    clock.mark("decode")
    if timings is not None:
        timings["decode_forwards"] = steps
        timings["decode_tokens"] = n
    return out, cache, p_total + n


class PhaseClock:
    """Host seconds between marks, each closed by a device synchronize,
    written into ``timings``; a no-op when ``timings`` is None."""

    def __init__(self, device: torch.device,
                 timings: Optional[Dict[str, float]]):
        self.device, self.timings = device, timings
        self.t0 = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timings is None:
            return
        now = self._now()
        self.timings[name] = now - self.t0
        self.t0 = now


def _trim_and_spans(tokens: np.ndarray, gen_cfg: GenerationConfig,
                    vocab: MultimodalVocab):
    """EOS trim + </img> span indices (reference generation.py:876-885)."""
    eos_positions = np.where(tokens == gen_cfg.eos_token_id)[0]
    end = int(eos_positions[0]) + 1 if eos_positions.size else len(tokens)
    tokens = tokens[:end]
    n_img = gen_cfg.num_img_gen_tokens
    eoi_indices = [int(i) for i in np.where(tokens == vocab.eoi)[0]
                   if i >= n_img]
    return tokens, eoi_indices


def build_result(tokens: np.ndarray, eoi_indices, img_gen_feat, tokenizer,
                 vocab: MultimodalVocab, num_img_gen_tokens: int
                 ) -> Dict[str, Any]:
    """Result dict from trimmed tokens + spans: forced image ids and <img>
    markers are dropped from the text (reference: seed_x.py:201-215)."""
    text_mask = np.ones(len(tokens), bool)
    for j in eoi_indices:
        text_mask[j - num_img_gen_tokens:j] = False
    text_mask[tokens == vocab.boi] = False
    return {"text": tokenizer.decode(tokens[text_mask]),
            "has_img_output": bool(eoi_indices),
            "img_gen_feat": img_gen_feat,
            "num_gen_imgs": len(eoi_indices),
            "tokens": tokens}


@torch.no_grad()
def generate_batch(model: ContinuousLVLM, tokenizer, requests,
                   gen_cfg: Optional[GenerationConfig] = None,
                   generator: Optional[torch.Generator] = None,
                   timings: Optional[Dict[str, float]] = None):
    """Batched generation: one prefill + decode loop for many prompts.
    Every request is a dict {"input_ids": list[int], "image_embeds":
    [N_i, T, vit_dim] or None, "embeds_cmp_mask": [N_i] bool or None,
    "ids_cmp_mask": [S_i] bool or None, "patch_positions": [N_i, 2] or
    None}.  Returns one result dict per request."""
    vocab = tokenizer.vocab
    gen_cfg = gen_cfg or GenerationConfig(eos_token_id=tokenizer.eos_token_id,
                                          pad_token_id=tokenizer.pad_token_id)
    dev = next(model.buffers()).device
    b = len(requests)
    lens = [len(r["input_ids"]) for r in requests]
    s_max = max(lens)
    bucket = next((x for x in gen_cfg.prompt_buckets if x >= s_max), s_max)

    ids_padded = np.full((b, bucket), gen_cfg.pad_token_id, np.int64)
    mask = np.zeros((b, bucket), bool)
    cmp_padded = np.zeros((b, bucket), bool)
    any_cmp = False
    for i, r in enumerate(requests):
        s = lens[i]
        ids_padded[i, bucket - s:] = np.asarray(r["input_ids"], np.int64)
        mask[i, bucket - s:] = True
        cm = r.get("ids_cmp_mask")
        if cm is not None:
            cmp_padded[i, bucket - s:] = np.asarray(cm, bool)
            any_cmp = True

    with_img = [r for r in requests if r.get("image_embeds") is not None]
    image_embeds = embeds_cmp = patch_pos = None
    if with_img:
        image_embeds = torch.cat([torch.as_tensor(r["image_embeds"],
                                                  device=dev)
                                  for r in with_img])
        embeds_cmp = torch.as_tensor(np.concatenate(
            [np.asarray(r["embeds_cmp_mask"], bool) for r in with_img]),
            device=dev)
        if any(r.get("patch_positions") is not None for r in with_img):
            # missing positions default to the thumbnail's center
            patch_pos = torch.cat([
                torch.as_tensor(r["patch_positions"], dtype=torch.float32,
                                device=dev)
                if r.get("patch_positions") is not None
                else torch.full((r["image_embeds"].shape[0], 2), 0.5,
                                device=dev)
                for r in with_img])

    prompt_embeds = model.embed_with_images(
        torch.as_tensor(ids_padded, device=dev), image_embeds,
        torch.as_tensor(cmp_padded, device=dev) if any_cmp else None,
        embeds_cmp, patch_pos)
    last_tokens = torch.as_tensor([r["input_ids"][-1] for r in requests],
                                  device=dev)
    out = generate_tokens(model, prompt_embeds,
                          torch.as_tensor(mask, device=dev), last_tokens,
                          gen_cfg, vocab, generator=generator,
                          timings=timings)
    all_tokens = out["tokens"].cpu().numpy()

    n_img = gen_cfg.num_img_gen_tokens
    rows, span_list = [], []
    for i in range(b):
        tokens, eoi_indices = _trim_and_spans(all_tokens[i], gen_cfg, vocab)
        rows.append((tokens, eoi_indices))
        span_list.extend((i, j) for j in eoi_indices)
    img_gen_all = None
    if span_list:
        spans = torch.stack([out["hidden"][i, j - n_img:j]
                             for i, j in span_list])
        img_gen_all = model.decode_image_feats(spans)

    results, consumed = [], 0
    for tokens, eoi_indices in rows:
        img_gen_feat = None
        if eoi_indices:
            img_gen_feat = img_gen_all[consumed:consumed + len(eoi_indices)]
            consumed += len(eoi_indices)
        results.append(build_result(tokens, eoi_indices, img_gen_feat,
                                    tokenizer, vocab, n_img))
    return results


def generate(model: ContinuousLVLM, tokenizer, input_ids,
             image_embeds=None, embeds_cmp_mask=None, ids_cmp_mask=None,
             patch_positions=None, gen_cfg: Optional[GenerationConfig] = None,
             generator: Optional[torch.Generator] = None,
             timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Single-prompt generation (reference ``ContinuousLVLM.generate``,
    seed_x.py:130-223): {text, has_img_output, img_gen_feat, num_gen_imgs,
    tokens}."""
    ids = np.asarray(input_ids)
    if ids.ndim == 2:
        if ids.shape[0] != 1:
            raise ValueError("generate() is single-prompt; use "
                             "generate_batch for multiple prompts")
        ids = ids[0]
    cm = np.asarray(ids_cmp_mask) if ids_cmp_mask is not None else None
    if cm is not None and cm.ndim == 2:
        cm = cm[0]
    request = {"input_ids": list(ids), "image_embeds": image_embeds,
               "embeds_cmp_mask": embeds_cmp_mask, "ids_cmp_mask": cm,
               "patch_positions": patch_positions}
    return generate_batch(model, tokenizer, [request], gen_cfg=gen_cfg,
                          generator=generator, timings=timings)[0]
