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
decode loop.

n-gram speculative decoding (``GenerationConfig.spec_k``, greedy B = 1)
is a second predicated step over the same state (``spec_step``: draft
``spec_k`` ids by prompt lookup in the token history ``hist``, verify
them in one (k + 1)-token forward, emit the verified prefix), captured
as a program of its own.  The adaptive gate's bit rides the flags: the
host replays the program of the gate's mode for a window and reads the
flags after it, and the step of the other mode is a no-op, so a flip
costs at most ``CHECK_EVERY - 1`` no-op replays.  ``script_ids`` forces
the emitted stream to a script at decision time (a static buffer both
programs read).  Beam search (``generate_tokens_beam``) is a fixed-trip
loop of one captured step that re-gathers every beam buffer, the KV
cache included, by parent in place; ``_backtrack_beam`` picks the
winner on the host.
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
    num_beams: int = 1
    length_penalty: float = 1.0   # HF-style: score / len**alpha
    eos_token_id: int = 2
    pad_token_id: int = 0
    prompt_buckets: tuple = (128, 256, 512, 1024)
    # n-gram speculative decoding (greedy, B = 1): draft spec_k tokens a
    # round from the continuation of the last spec_ngram-gram's previous
    # occurrence in prompt + generated text, verify them in one forward.
    # Exact: emits the greedy sequence.  0 disables.
    spec_k: int = 0
    spec_ngram: int = 3
    # The adaptive gate: speculate while the acceptance rate over the last
    # spec_window rounds clears spec_min_accept; a window of >=
    # spec_probe_rounds rounds below it turns speculation off for
    # spec_reprobe plain steps, then it probes again.  The counters
    # (spec_rounds, spec_accepted) ride the result.
    spec_adaptive: bool = True
    spec_probe_rounds: int = 4
    spec_min_accept: float = 0.8
    spec_reprobe: int = 48
    spec_window: int = 32


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


def _ngram_draft(hist: torch.Tensor, m, token0, k: int,
                 ngram: int = 3) -> torch.Tensor:
    """Prompt-lookup drafting (reference generation.py:119-141): the k ids
    after the most recent earlier occurrence of the tail n-gram.

    hist [L] int64 token history, -1 in unfilled or pad slots; hist[:m]
    is filled and ``token0`` (0-d) is the decided next token at virtual
    position m (0-d tensor or int).  Returns [k] draft ids, -1 where
    nothing matched (-1 never verifies)."""
    if ngram < 2:
        raise ValueError(f"spec_ngram must be >= 2, got {ngram}")
    n_hist = hist.shape[0]
    idx = torch.arange(n_hist, device=hist.device)
    m = torch.as_tensor(m, device=hist.device)
    match = hist == token0
    # the tail (ngram-1)-gram before token0 must match at each candidate
    for o in range(1, ngram):
        key = hist.index_select(0, torch.clamp(m - o, min=0).view(1))
        match &= torch.roll(hist, o) == key
    match &= (idx >= ngram - 1) & (idx < m)
    j = torch.where(match, idx, -1).amax()
    start = torch.clamp(j + 1, 0, n_hist - k)
    drafts = hist.index_select(0, start + torch.arange(k, device=hist.device))
    return torch.where(j >= 0, drafts, -1)


# the gate's state, a [6] int64 device tensor (reference
# generation.py:144-175): rounds, accepted, rounds_w, acc_w, cooldown,
# spec_on (0 / 1)
GATE_FIELDS = ("rounds", "accepted", "rounds_w", "acc_w", "cooldown",
               "spec_on")


def _spec_gate_update(sp: torch.Tensor, a: torch.Tensor,
                      gen_cfg: GenerationConfig) -> torch.Tensor:
    """One speculative round's bookkeeping (``a`` drafts accepted): a
    window of >= spec_probe_rounds rounds whose acceptance rate misses
    spec_min_accept turns speculation off and arms a spec_reprobe-step
    cooldown; a window that clears the bar rolls every spec_window
    rounds."""
    rounds, accepted, rounds_w, acc_w, cooldown, spec_on = sp.unbind()
    rounds, accepted = rounds + 1, accepted + a
    rounds_w, acc_w = rounds_w + 1, acc_w + a
    if not gen_cfg.spec_adaptive:
        return torch.stack([rounds, accepted, rounds_w, acc_w, cooldown,
                            spec_on])
    fail = ((rounds_w >= gen_cfg.spec_probe_rounds)
            & (acc_w.float()
               < gen_cfg.spec_min_accept * rounds_w.float()))
    reset = fail | (rounds_w >= gen_cfg.spec_window)
    return torch.stack([
        rounds, accepted, torch.where(reset, 0, rounds_w),
        torch.where(reset, 0, acc_w),
        torch.where(fail, gen_cfg.spec_reprobe, cooldown),
        spec_on * (~fail).long()])


def _spec_cooldown_tick(sp: torch.Tensor) -> torch.Tensor:
    """One plain step while the gate is off: count down to the
    re-probe."""
    cooldown = sp[4] - 1
    on = (sp[5] != 0) | (cooldown <= 0)
    return torch.stack([sp[0], sp[1], sp[2], sp[3], cooldown, on.long()])


def _force_script(logits2d: torch.Tensor, pos_out: torch.Tensor,
                  script: Optional[torch.Tensor], t: int) -> torch.Tensor:
    """Force the argmax of logits2d [R, V] to ``script``'s token at each
    output position pos_out [R] (max + 10, -1e9 elsewhere; reference
    generation.py:283-298); positions >= t are left as they are (never
    emitted).  ``script`` None: no forcing."""
    if script is None:
        return logits2d
    tokw = script.index_select(0, torch.clamp(pos_out, 0, t - 1))
    ids = torch.arange(logits2d.shape[-1], device=logits2d.device)
    win = logits2d.amax(dim=-1, keepdim=True) + 10.0
    forced = torch.where(ids[None, :] == tokw[:, None], win,
                         torch.full_like(logits2d, -1e9))
    return torch.where((pos_out < t)[:, None], forced, logits2d)


def _scatter_drop(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  ok: torch.Tensor) -> None:
    """buf[idx[i]] = vals[i] along dim 0 where ok[i], in place; an index
    outside [0, len(buf)) is dropped (JAX ``.at[].set(mode="drop")``).
    The indices must be distinct.  Static shapes: every cell is rewritten,
    with its own value where no write lands."""
    hit = ((idx[:, None] == torch.arange(buf.shape[0],
                                         device=buf.device)[None, :])
           & ok[:, None])
    src = vals.index_select(0, hit.long().argmax(dim=0)).to(buf.dtype)
    mask = hit.any(dim=0).view((-1,) + (1,) * (buf.dim() - 1))
    buf.copy_(torch.where(mask, src, buf))


def spec_width(gen_cfg: GenerationConfig, b: int, has_ids: bool) -> int:
    """The draft length speculative decoding runs with: ``spec_k`` for a
    greedy B = 1 request with its ids (``prompt_ids`` / ``hist_ids``),
    else 0 (reference generation.py:246-250)."""
    return (gen_cfg.spec_k if gen_cfg.spec_k > 0 and b == 1
            and not gen_cfg.do_sample and has_ids else 0)


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
                    timings: Optional[Dict[str, float]] = None,
                    prompt_ids: Optional[torch.Tensor] = None,
                    script_ids: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """prompt_embeds [B, P, D] (image embeds spliced), prompt_mask [B, P]
    bool LEFT-padded, last_prompt_token [B] -> {tokens [B, T], hidden
    [B, T, D], finished [B, T], spec_rounds, spec_accepted}; hidden[:, i]
    is the state that produced tokens[:, i] (reference alignment,
    seed_x.py:196-207).

    ``prompt_ids`` [B, P] (the padded ids) enables speculative decoding
    when ``gen_cfg.spec_k`` > 0, the batch is 1 and decoding is greedy
    (else ``spec_k`` silently becomes 0).  ``script_ids`` [T] (B = 1)
    pins the emitted stream to a script by forcing the logits at decision
    time (reference generation.py:210-220): every forward still runs the
    model, but the token at output position i is ``script_ids[i]``; spec
    acceptance is a function of the token stream alone, so a script
    replays a transcript's acceptance through the real engine.

    ``timings``, when given, receives host seconds for "prefill" and
    "decode" (each closed by a device synchronize), the decode forwards
    in "decode_forwards", the tokens they emitted in "decode_tokens", and
    with speculation the replays and host seconds of each mode's windows
    and the gate's flips (``_decode_loop``).  With the agent's graphs on,
    the KV cache and the captured decode steps of a shape are kept by the
    agent (``DecodePrograms``)."""
    b, p, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    t = gen_cfg.max_new_tokens
    if script_ids is not None and b != 1:
        raise ValueError("script_ids forcing is a greedy B=1 feature")
    spec_k = spec_width(gen_cfg, b, prompt_ids is not None)
    # a verify forward writes spec_k + 1 cache rows even where fewer
    # tokens are accepted near t: the cache gets spec_k rows of headroom
    t_cache = t + spec_k
    kind = dict(spec_k=spec_k, hist_len=p + t if spec_k else 0,
                scripted=script_ids is not None)
    if model.graphs.active(dev):
        st = decode_programs(model).state(model, b, p + t_cache, gen_cfg,
                                          vocab, dev, **kind)
    else:
        st = DecodeState(model, init_kv_cache(model.cfg.llm, b, p + t_cache,
                                              device=dev,
                                              kv_heads=model.llm.kv_heads),
                         b, gen_cfg, vocab, None, **kind)

    clock = PhaseClock(dev, timings)
    positions = positions_from_mask(prompt_mask)
    kv_valid = torch.cat([prompt_mask,
                          torch.zeros((b, t_cache), dtype=torch.bool,
                                      device=dev)], dim=-1)
    logits, hidden, _ = model.llm_step(prompt_embeds, positions, kv_valid,
                                       st.cache, 0)
    clock.mark("prefill")
    hist = None
    if spec_k:
        # prompt at [0, p), generated token i at p + i; -1 marks pad and
        # unwritten slots (never matches a draft)
        hist = torch.cat([
            torch.where(prompt_mask[0], prompt_ids[0].to(dev, torch.int64),
                        -1),
            torch.full((t,), -1, dtype=torch.int64, device=dev)])
    out, info = _decode_loop(
        model, st, kv_valid, p, logits[:, -1].float(), hidden[:, -1],
        positions[:, -1], last_prompt_token.to(dev, torch.int64), gen_cfg,
        vocab, generator, hist=hist, script=script_ids)
    clock.mark("decode")
    if timings is not None:
        timings.update(info)
    return out


class DecodeState:
    """The decode loop's state as static device buffers, updated in place
    by ``decode_step`` and ``spec_step`` (the state tuple of the JAX
    package's ``_run_decode_loop``): the tokens decoded ``n`` and the
    forwards run, each row's ``finished`` flag, previous token, logits,
    hidden state and position, the outputs, the kv mask of the prompt
    (``prefix_valid``), the first generated position ``base`` and the
    sampling steps of the current check window (``drawn``, the slot of
    ``noise``, the window's draws when ``gen_cfg`` samples).  With
    speculation (``spec_k`` > 0, B = 1): the token history ``hist``
    [hist_len] (output token n at ``base + n``) and the gate ``sp`` [6]
    (``GATE_FIELDS``); with ``scripted`` the forced stream ``script``
    [T].  ``flags`` [11] int64 (stop, at a chunkable ``<img>``, n,
    forwards, drawn, then ``sp``) is what the host reads.  Its
    ``program`` is the one-token step over these buffers and the KV
    ``cache``, ``spec_program`` the verify round (with speculation), each
    captured while ``graphs`` is on (None: always eager)."""

    def __init__(self, model: ContinuousLVLM, cache, b: int,
                 gen_cfg: GenerationConfig, vocab: MultimodalVocab,
                 graphs: Optional[Graphs], spec_k: int = 0,
                 hist_len: int = 0, scripted: bool = False):
        cfg = model.cfg.llm
        dev = cache[0].device
        t = gen_cfg.max_new_tokens
        i64 = dict(dtype=torch.int64, device=dev)
        if (spec_k or scripted) and b != 1:
            raise ValueError("speculation and script forcing are B=1 "
                             "features")
        if spec_k:
            cfg.refuse("speculative decoding")
        self.cache, self.gen_cfg, self.spec_k = cache, gen_cfg, spec_k
        self.n = torch.zeros((), **i64)
        self.forwards = torch.zeros((), **i64)
        self.drawn = torch.zeros((), **i64)
        self.base = torch.zeros((), **i64)
        self.flags = torch.zeros((5 + len(GATE_FIELDS),), **i64)
        self.prefix_valid = torch.zeros((b, cache[0].shape[2]),
                                        dtype=torch.bool, device=dev)
        self.finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.prev_token = torch.zeros((b,), **i64)
        self.prev_logits = torch.zeros((b, cfg.padded_vocab_size),
                                       dtype=torch.float32, device=dev)
        self.prev_hidden = torch.zeros((b, cfg.hidden_size), dtype=cfg.dtype,
                                       device=dev)
        self.prev_pos = torch.zeros((b,), **i64)
        self.out_tokens = torch.zeros((b, t), **i64)
        self.out_hidden = torch.zeros((b, t, cfg.hidden_size),
                                      dtype=cfg.dtype, device=dev)
        self.out_finished = torch.zeros((b, t), dtype=torch.bool, device=dev)
        self.sp = torch.zeros((len(GATE_FIELDS),), **i64)
        self.hist = torch.full((hist_len,), -1, **i64) if spec_k else None
        self.script = torch.zeros((t,), **i64) if scripted else None
        self.noise = (SampleNoise(b, cfg.padded_vocab_size, CHECK_EVERY,
                                  dev) if gen_cfg.do_sample else None)
        self.program = Program(
            lambda: decode_step(model, self, gen_cfg, vocab), dev, graphs)
        self.spec_program = Program(
            lambda: spec_step(model, self, gen_cfg, vocab), dev,
            graphs) if spec_k else None

    def programs(self):
        return [p for p in (self.program, self.spec_program)
                if p is not None]

    def reset(self, prefix_valid, base: int, prev_logits, prev_hidden,
              prev_pos, prev_token, gen_cfg: GenerationConfig,
              vocab: MultimodalVocab, hist=None, script=None) -> None:
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
        self.sp.zero_()
        self.sp[5] = 1
        if self.hist is not None:
            self.hist.copy_(hist)
        if self.script is not None:
            # a script shorter than T repeats its last token (the JAX
            # package's gather clamps the index)
            s = torch.as_tensor(script).reshape(-1)[:self.script.shape[0]]
            self.script.copy_(torch.cat([s, s[-1:].expand(
                self.script.shape[0] - s.shape[0])]))
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
        self.flags.copy_(torch.cat([torch.stack([
            stop.long(), chunk.long(), self.n, self.forwards, self.drawn]),
            self.sp]))


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
    image-token constraint (and the script), record it, run it through
    the model at cache position ``base + n``.  The step is a no-op (no
    output, counter or live cache cell changes; its forward still runs,
    with its cache writes masked) when decode has stopped, sits at a
    chunkable ``<img>``, or (with speculation) the gate is on: a
    replayed program runs it regardless.  With speculation it ticks the
    gate's cooldown and extends ``hist``."""
    b, t = st.out_tokens.shape
    n_img = gen_cfg.num_img_gen_tokens
    c = st.cache[0].shape[2]
    stop, chunk = st.stop_and_chunk(gen_cfg, vocab)
    live = ~(stop | chunk)
    if st.spec_k:
        live = live & (st.sp[5] == 0)
    constrained = constrain_image_tokens(st.prev_token, st.prev_logits, vocab,
                                         n_img)
    constrained = _force_script(constrained, st.n.expand(b), st.script, t)
    noise = None if st.noise is None else st.noise.at(st.drawn)
    token = _sample(constrained, gen_cfg, noise=noise)
    token = torch.where(st.finished, gen_cfg.pad_token_id, token)
    finished = st.finished | (token == gen_cfg.eos_token_id)
    col = torch.clamp(st.n, max=t - 1).view(1)
    _put_col(st.out_tokens, col, token, live)
    _put_col(st.out_hidden, col, st.prev_hidden, live)
    _put_col(st.out_finished, col, finished, live)
    if st.spec_k:
        # gated-off steps extend the history too: a hole there would
        # corrupt every later draft's lookup (generation.py:339-346)
        _scatter_drop(st.hist, (st.base + st.n).view(1), token, live.view(1))
        st.sp.copy_(torch.where(live, _spec_cooldown_tick(st.sp), st.sp))
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
def spec_step(model: ContinuousLVLM, st: DecodeState,
              gen_cfg: GenerationConfig, vocab: MultimodalVocab) -> None:
    """One predicated speculative round on ``st`` in place (JAX
    ``spec_step``, generation.py:383-443; greedy, B = 1): decide the next
    token from the carried logits, draft ``spec_k`` continuations from
    ``hist``, verify all of them in one (k + 1)-token forward at cache
    position ``base + n`` (the windowed fused step: K3's stair, K2 at
    k + 1 rows), emit the verified prefix and carry the last accepted
    position's logits.  No host read.  A no-op (outputs, counters and
    live cache cells unchanged, its writes dropped) when decode has
    stopped, sits at a chunkable ``<img>``, or the gate is off."""
    k = st.spec_k
    t = st.out_tokens.shape[1]
    n_img = gen_cfg.num_img_gen_tokens
    c = st.cache[0].shape[2]
    dev = st.n.device
    stop, chunk = st.stop_and_chunk(gen_cfg, vocab)
    live = ~(stop | chunk) & (st.sp[5] != 0)
    constrained = constrain_image_tokens(st.prev_token, st.prev_logits, vocab,
                                         n_img)
    constrained = _force_script(constrained, st.n.view(1), st.script, t)
    token0 = torch.argmax(constrained, dim=-1)                     # [1]
    drafts = _ngram_draft(st.hist, st.base + st.n, token0[0], k,
                          gen_cfg.spec_ngram)
    v = torch.cat([token0, drafts])                                # [k+1]
    i_vec = torch.arange(k + 1, device=dev)
    pos = st.prev_pos[:, None] + 1 + i_vec[None, :]
    # a no-op step (n == t) still reads a window inside the cache
    at = st.base + torch.clamp(st.n, max=t - 1)
    span = torch.arange(c, device=dev)
    kv_valid = st.prefix_valid | ((span >= st.base)
                                  & (span < at + k + 1))[None]
    logits_v, hidden_v, _ = model.llm_step(
        model.embed_ids(torch.clamp(v, min=0)[None]), pos, kv_valid,
        st.cache, at.view(1), write_widths=(live.long() * (k + 1)).view(1))
    logits_v, hidden_v = logits_v[0].float(), hidden_v[0]
    # the exact token after each verify position (verify position i sits
    # at output position n + i, so its next is script position n + 1 + i)
    exp_next = torch.argmax(_force_script(
        constrain_image_tokens(v, logits_v, vocab, n_img),
        st.n + 1 + i_vec, st.script, t), dim=-1)
    # accept drafts while they match and no stopper was emitted: eos ends
    # the sequence, <img> hands over to the forced chunk
    stop_prev = (v[:k] == gen_cfg.eos_token_id) | (v[:k] == vocab.boi)
    acc = (drafts == exp_next[:k]) & ~stop_prev
    a = torch.cumprod(acc.long(), dim=0).sum()
    e_count = a + 1
    emit = (i_vec < e_count) & live
    hid_w = torch.cat([st.prev_hidden, hidden_v[:k]])              # [k+1, D]
    cols = st.n + i_vec
    _scatter_drop(st.out_tokens[0], cols, v, emit)
    _scatter_drop(st.out_hidden[0], cols, hid_w, emit)
    _scatter_drop(st.out_finished[0], cols, v == gen_cfg.eos_token_id, emit)
    _scatter_drop(st.hist, st.base + cols, v, emit)
    sel = a.view(1)
    last_tok = v.index_select(0, sel)
    st.prev_logits.copy_(torch.where(live, logits_v.index_select(0, sel),
                                     st.prev_logits))
    st.prev_hidden.copy_(torch.where(live, hidden_v.index_select(0, sel),
                                     st.prev_hidden))
    st.prev_pos.copy_(torch.where(live, st.prev_pos + e_count, st.prev_pos))
    st.prev_token.copy_(torch.where(live, last_tok, st.prev_token))
    st.finished.copy_(torch.where(
        live, st.finished | (last_tok == gen_cfg.eos_token_id), st.finished))
    st.sp.copy_(torch.where(live, _spec_gate_update(st.sp, a, gen_cfg),
                            st.sp))
    st.n.add_(torch.where(live, e_count, 0))
    st.forwards.add_(live.long())
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
    if st.spec_k:
        st.hist[base + n:base + n + c] = ids[0]
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
    generation config, draft length, scripted or not), each with its
    captured steps, and ``generate_tokens_beam``'s beam states, one per
    shape.  Their KV caches are views of one storage, sized for the
    largest shape yet asked for (``reserve``): calls run one at a time and
    a call reads only cache cells it wrote, so one storage serves every
    shape.  Their graphs share the agent's graph pool, so what is kept
    between calls is one KV cache of the largest shape, one pool and each
    shape's small buffers.  A shape the storage cannot hold replaces it,
    and drops every state (its graph points at the old storage)."""

    def __init__(self):
        self.states: Dict[tuple, Any] = {}
        self._storage: tuple = ()

    def reserve(self, model: ContinuousLVLM, b: int, length: int,
                dev) -> None:
        """Size the KV storage for ``b`` rows of ``length`` positions."""
        need = [(math.prod(x.shape), x.dtype) for x in
                init_kv_cache(model.cfg.llm, b, length, device="meta",
                              kv_heads=model.llm.kv_heads)]
        if len(self._storage) == len(need) and all(
                s.numel() >= n and s.dtype == dt
                for s, (n, dt) in zip(self._storage, need)):
            return
        self.states.clear()
        self._storage = ()
        self._storage = tuple(torch.zeros(n, dtype=dt, device=dev)
                              for n, dt in need)

    def _cache(self, model: ContinuousLVLM, b: int, length: int, dev):
        self.reserve(model, b, length, dev)
        return tuple(
            s[:math.prod(x.shape)].view(x.shape) for s, x in zip(
                self._storage, init_kv_cache(model.cfg.llm, b, length,
                                             device="meta",
                                             kv_heads=model.llm.kv_heads)))

    def state(self, model: ContinuousLVLM, b: int, length: int,
              gen_cfg: GenerationConfig, vocab: MultimodalVocab, dev,
              spec_k: int = 0, hist_len: int = 0,
              scripted: bool = False) -> "DecodeState":
        key = (b, length, gen_cfg, vocab, spec_k, scripted)
        st = self.states.get(key)
        if st is None:
            cache = self._cache(model, b, length, dev)
            st = DecodeState(model, cache, b, gen_cfg, vocab, model.graphs,
                             spec_k=spec_k, hist_len=hist_len,
                             scripted=scripted)
            self.states[key] = st
        return st

    def beam_state(self, model: ContinuousLVLM, b: int, p: int,
                   gen_cfg: GenerationConfig, vocab: MultimodalVocab,
                   dev) -> "BeamState":
        key = ("beam", b, p, gen_cfg, vocab)
        st = self.states.get(key)
        if st is None:
            k = gen_cfg.num_beams
            cache = self._cache(model, b * k, p + gen_cfg.max_new_tokens,
                                dev)
            st = BeamState(model, cache, b, p, gen_cfg, vocab, model.graphs)
            self.states[key] = st
        return st

    def warm(self, model: ContinuousLVLM, b: int, bucket: int,
             gen_cfg: GenerationConfig, vocab: MultimodalVocab) -> None:
        """Capture ahead of time the decode steps ``generate_batch`` runs
        at batch ``b`` and prompt bucket ``bucket`` (their warm runs are on
        an inert state, every row finished: no-ops).  Nothing to do off
        the card or with the agent's graphs off."""
        dev = next(model.buffers()).device
        if not model.graphs.active(dev):
            return
        spec_k = spec_width(gen_cfg, b, True)
        t = gen_cfg.max_new_tokens
        st = self.state(model, b, bucket + t + spec_k, gen_cfg, vocab, dev,
                        spec_k=spec_k, hist_len=bucket + t if spec_k else 0)
        for prog in st.programs():
            if prog.graph is None:
                st.finished.fill_(True)
                prog()

    def programs(self):
        return [p for st in self.states.values() for p in st.programs()]


def decode_programs(model: ContinuousLVLM) -> DecodePrograms:
    """The agent's ``DecodePrograms`` (made at its first use)."""
    if "decode_programs" not in vars(model):
        model.decode_programs = DecodePrograms()
    return model.decode_programs


def _decode_loop(model: ContinuousLVLM, st: DecodeState, prefix_valid,
                 base: int, prev_logits, prev_hidden, prev_pos, prev_token,
                 gen_cfg: GenerationConfig, vocab: MultimodalVocab,
                 generator: Optional[torch.Generator], hist=None,
                 script=None):
    """The decode loop shared by ``generate_tokens`` and
    ``generate_tokens_cached``, in the segments of the JAX package's
    ``_run_decode_loop``: windows of one program replayed (``decode_step``,
    one token a forward, or with the gate on ``spec_step``, one verify
    round), the host reading the flags after each window (and never
    stepping past ``n == t``), and the forced chunk, an eager forward, at
    exactly the ``n`` where every live row sits at ``<img>``.  A window
    is at most ``CHECK_EVERY`` replays, and no longer than the remaining
    tokens, the gate's probe rounds or its cooldown need, so a gate that
    flips at a probe's end or a cooldown's costs no no-op replay.
    Sampling draws a window's noise before it and gives back what its
    no-op steps did not take (``SampleNoise``; ``generator`` None: the
    device's default).  Output token n is written to cache position
    ``base + n``; ``prefix_valid`` [B, C] is the prompt's kv mask; ``hist``
    and ``script`` seed the state's buffers.  Returns (out dict, info):
    the out tensors are the caller's own; info has the forwards run
    ("decode_forwards"), the tokens decoded ("decode_tokens"), and per
    mode the replays and host seconds of its windows ("verify_replays",
    "verify_s", "plain_replays", "plain_s") and the gate's flips seen
    between windows ("gate_flips")."""
    t = gen_cfg.max_new_tokens
    k = st.spec_k
    st.reset(prefix_valid, base, prev_logits, prev_hidden, prev_pos,
             prev_token, gen_cfg, vocab, hist=hist, script=script)
    if st.noise is not None and generator is None:
        generator = default_generator(st.n.device)
    info = {"verify_replays": 0, "verify_s": 0.0, "plain_replays": 0,
            "plain_s": 0.0, "gate_flips": 0}
    mode, t_mark, was_on = None, 0.0, True
    while True:
        flags = st.flags.tolist()
        stop, chunk, n, forwards, drawn = flags[:5]
        gate = dict(zip(GATE_FIELDS, flags[5:]))
        if mode is not None:
            info[f"{mode}_s"] += time.perf_counter() - t_mark
            mode = None
        if st.noise is not None:
            st.noise.give_back(drawn)
        if k and bool(gate["spec_on"]) != was_on:
            info["gate_flips"] += 1
            was_on = bool(gate["spec_on"])
        if stop:
            break
        if chunk:
            _image_chunk(model, st, base, n, gen_cfg, vocab)
            continue
        if k and gate["spec_on"]:
            mode, program = "verify", st.spec_program
            # a round emits 1 to k + 1 tokens; in a probe the gate cannot
            # fail before spec_probe_rounds rounds
            steps = min(CHECK_EVERY, -(-(t - n) // (k + 1)))
            if gen_cfg.spec_adaptive and \
                    gate["rounds_w"] < gen_cfg.spec_probe_rounds:
                steps = min(steps,
                            gen_cfg.spec_probe_rounds - gate["rounds_w"])
        else:
            mode, program = "plain", st.program
            steps = min(CHECK_EVERY, t - n)
            if k:
                steps = min(steps, max(gate["cooldown"], 1))
        st.drawn.zero_()
        if st.noise is not None:
            st.noise.draw(generator, steps)
        info[f"{mode}_replays"] += steps
        t_mark = time.perf_counter()
        for _ in range(steps):
            program()
    out = {"tokens": st.out_tokens.clone(), "hidden": st.out_hidden.clone(),
           "finished": st.out_finished.clone(),
           "spec_rounds": st.sp[0].clone(),
           "spec_accepted": st.sp[1].clone()}
    info.update(decode_forwards=forwards, decode_tokens=n)
    return out, info


@torch.no_grad()
def generate_tokens_cached(model: ContinuousLVLM, cache, seg_embeds,
                           seg_start: int, seg_len: int,
                           last_prompt_token: int, gen_cfg: GenerationConfig,
                           vocab: MultimodalVocab = DEFAULT_VOCAB,
                           generator: Optional[torch.Generator] = None,
                           timings: Optional[Dict[str, float]] = None,
                           decode: Optional[DecodeState] = None,
                           hist_ids: Optional[torch.Tensor] = None):
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
    position.  ``hist_ids`` [C] (the ids at absolute cache positions, -1
    in unfilled or stale slots) enables speculative decoding when
    ``gen_cfg.spec_k`` > 0 and decoding is greedy; the caller then sizes
    the cache with ``spec_k`` rows of headroom past the prompt and
    ``max_new_tokens`` (a verify forward writes k rows ahead).  ``decode``
    is the caller's decode state over ``cache`` (a chat session's, kept
    with its cache and captured while the agent's graphs are on); without
    it decode runs eagerly.  Returns (out dict, cache, seg_start + seg_len
    + tokens decoded); the cache is updated in place.  ``timings`` as in
    ``generate_tokens``."""
    dev = seg_embeds.device
    c = cache[0].shape[2]
    sb = seg_embeds.shape[1]
    spec_k = spec_width(gen_cfg, 1, hist_ids is not None)
    hist = (torch.as_tensor(hist_ids, device=dev).reshape(-1).long()
            if spec_k else None)
    if decode is None:
        decode = DecodeState(model, cache, 1, gen_cfg, vocab, None,
                             spec_k=spec_k,
                             hist_len=hist.shape[0] if spec_k else 0)
    elif (decode.cache is not cache or decode.gen_cfg != gen_cfg
          or decode.spec_k != spec_k):
        raise ValueError("generate_tokens_cached: the decode state is not "
                         "this cache's, this generation config's or this "
                         "draft length's")
    clock = PhaseClock(dev, timings)
    positions = (seg_start + torch.arange(sb, device=dev))[None]
    kv_valid = (torch.arange(c, device=dev) < seg_start + seg_len)[None]
    logits, hidden, _ = model.llm_step(seg_embeds, positions, kv_valid,
                                       cache, seg_start)
    clock.mark("prefill")
    p_total = seg_start + seg_len
    out, info = _decode_loop(
        model, decode, kv_valid, p_total, logits[:, seg_len - 1].float(),
        hidden[:, seg_len - 1],
        torch.full((1,), p_total - 1, dtype=torch.int64, device=dev),
        torch.full((1,), last_prompt_token, dtype=torch.int64, device=dev),
        gen_cfg, vocab, generator, hist=hist)
    clock.mark("decode")
    if timings is not None:
        timings.update(info)
    return out, cache, p_total + info["decode_tokens"]


class BeamState:
    """Beam search's state as static device buffers (the carry of the JAX
    package's ``generate_tokens_beam`` scan), updated in place by
    ``beam_step``: the KV ``cache`` of B*K rows (row-major [b, k]), each
    beam's logits, hidden state, position, previous token and finished
    flag, the scores [B, K], the step index, and the outputs (tokens and
    parents [T, B, K], hidden [T, B*K, D], finished [T, B*K]).  Its
    ``program`` is one beam step, captured while ``graphs`` is on."""

    def __init__(self, model: ContinuousLVLM, cache, b: int, p: int,
                 gen_cfg: GenerationConfig, vocab: MultimodalVocab,
                 graphs: Optional[Graphs]):
        cfg = model.cfg.llm
        cfg.refuse("beam search")
        dev = cache[0].device
        k, t = gen_cfg.num_beams, gen_cfg.max_new_tokens
        bk = b * k
        i64 = dict(dtype=torch.int64, device=dev)
        self.cache = cache
        self.step_idx = torch.zeros((), **i64)
        self.prompt_mask = torch.zeros((bk, p), dtype=torch.bool, device=dev)
        self.prev_logits = torch.zeros((bk, cfg.padded_vocab_size),
                                       dtype=torch.float32, device=dev)
        self.prev_hidden = torch.zeros((bk, cfg.hidden_size),
                                       dtype=cfg.dtype, device=dev)
        self.prev_pos = torch.zeros((bk,), **i64)
        self.prev_token = torch.zeros((bk,), **i64)
        self.finished = torch.zeros((bk,), dtype=torch.bool, device=dev)
        self.scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
        self.tokens = torch.zeros((t, b, k), **i64)
        self.parents = torch.zeros((t, b, k), **i64)
        self.hidden = torch.zeros((t, bk, cfg.hidden_size), dtype=cfg.dtype,
                                  device=dev)
        self.out_finished = torch.zeros((t, bk), dtype=torch.bool,
                                        device=dev)
        self.program = Program(
            lambda: beam_step(model, self, gen_cfg, vocab), dev, graphs)

    def programs(self):
        return [self.program]


def _gather_rows(c: torch.Tensor, rows: torch.Tensor) -> None:
    """c[:, i] = c[:, rows[i]] in place for a cache leaf [L, B*K, ...]:
    each row's cells moved as 8-byte words where they divide so (int8
    codes and bf16 scales byte for byte as they are)."""
    flat = c.view(c.shape[0], c.shape[1], -1)
    if (flat.shape[-1] * flat.element_size()) % 8 == 0:
        flat = flat.view(torch.int64)
    flat.copy_(flat.index_select(1, rows))


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (as ``jax.lax.top_k``): a stable
    descending sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def beam_step(model: ContinuousLVLM, st: BeamState,
              gen_cfg: GenerationConfig, vocab: MultimodalVocab) -> None:
    """One beam step on ``st`` in place (the body of JAX
    ``generate_tokens_beam``'s scan, generation.py:792-829): constrained
    log-softmax, pad-only rows for finished beams, a joint top-k over
    each batch row's K * V candidates, every beam buffer (the KV cache
    included) re-gathered by parent, then the chosen tokens through the
    model at cache position P + step (per-row, K3's one-query mode)."""
    b, k = st.scores.shape
    bk = b * k
    t = st.tokens.shape[0]
    p = st.prompt_mask.shape[1]
    dev = st.scores.device
    constrained = constrain_image_tokens(st.prev_token, st.prev_logits, vocab,
                                         gen_cfg.num_img_gen_tokens)
    logprobs = torch.log_softmax(constrained, dim=-1)
    v = logprobs.shape[-1]
    # finished beams: pad costs 0, everything else -inf
    ids = torch.arange(v, device=dev)
    pad_row = torch.where(ids == gen_cfg.pad_token_id, 0.0, float("-inf"))
    logprobs = torch.where(st.finished[:, None], pad_row[None, :], logprobs)
    total = st.scores.reshape(bk, 1) + logprobs
    top_scores, top_idx = _top_k(total.reshape(b, k * v), k)
    parent = top_idx // v
    token = top_idx % v
    rows = (torch.arange(b, device=dev)[:, None] * k + parent).reshape(-1)
    for c in st.cache:
        _gather_rows(c, rows)
    hidden_src = st.prev_hidden.index_select(0, rows)
    pos = st.prev_pos.index_select(0, rows) + 1
    token_flat = token.reshape(-1)
    finished = (st.finished.index_select(0, rows)
                | (token_flat == gen_cfg.eos_token_id))
    s = st.step_idx
    kv_valid = torch.cat([
        st.prompt_mask,
        (torch.arange(t, device=dev) <= s)[None, :].expand(bk, t)], dim=-1)
    logits, hidden, _ = model.llm_step(
        model.embed_ids(token_flat[:, None]), pos[:, None], kv_valid,
        st.cache, (p + s).expand(bk))
    col = torch.clamp(s, max=t - 1).view(1)
    st.tokens.index_copy_(0, col, token[None])
    st.parents.index_copy_(0, col, parent[None])
    st.hidden.index_copy_(0, col, hidden_src[None])
    st.out_finished.index_copy_(0, col, finished[None])
    st.prev_logits.copy_(logits[:, 0].float())
    st.prev_hidden.copy_(hidden[:, 0])
    st.prev_pos.copy_(pos)
    st.prev_token.copy_(token_flat)
    st.finished.copy_(finished)
    st.scores.copy_(top_scores)
    st.step_idx.add_(1)


@torch.no_grad()
def generate_tokens_beam(model: ContinuousLVLM, prompt_embeds: torch.Tensor,
                         prompt_mask: torch.Tensor,
                         last_prompt_token: torch.Tensor,
                         gen_cfg: GenerationConfig,
                         vocab: MultimodalVocab = DEFAULT_VOCAB,
                         timings: Optional[Dict[str, float]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Beam search (reference generate_tokens_beam, generation.py:743-836;
    HF ``num_beams > 1``).  One prefill at batch B, the cache tiled to B*K
    beam rows, then ``max_new_tokens`` beam steps (``beam_step``, one
    captured program replayed, the host reading nothing in between).
    Finished beams emit pad with frozen scores and keep competing.

    Returns {tokens [T, B, K], parents [T, B, K], hidden [T, B*K, D],
    scores [B, K], finished [T, B*K]}; ``_backtrack_beam`` reconstructs
    the best beam.  ``timings`` receives "prefill" and "decode" host
    seconds and the steps in "decode_forwards"."""
    b, p, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    k, t = gen_cfg.num_beams, gen_cfg.max_new_tokens
    if model.graphs.active(dev):
        st = decode_programs(model).beam_state(model, b, p, gen_cfg, vocab,
                                               dev)
    else:
        st = BeamState(model, init_kv_cache(model.cfg.llm, b * k, p + t,
                                            device=dev,
                                            kv_heads=model.llm.kv_heads),
                       b, p, gen_cfg, vocab, None)
    clock = PhaseClock(dev, timings)
    cache = init_kv_cache(model.cfg.llm, b, p + t, device=dev,
                          kv_heads=model.llm.kv_heads)
    positions = positions_from_mask(prompt_mask)
    kv_valid = torch.cat([prompt_mask,
                          torch.zeros((b, t), dtype=torch.bool, device=dev)],
                         dim=-1)
    logits, hidden, _ = model.llm_step(prompt_embeds, positions, kv_valid,
                                       cache, 0)
    # beam expansion: row-major [b, k] blocks
    for dst, src in zip(st.cache, cache):
        dst.copy_(src.repeat_interleave(k, dim=1))
    del cache
    st.step_idx.zero_()
    st.prompt_mask.copy_(prompt_mask.repeat_interleave(k, dim=0))
    st.prev_logits.copy_(logits[:, -1].float().repeat_interleave(k, dim=0))
    st.prev_hidden.copy_(hidden[:, -1].repeat_interleave(k, dim=0))
    st.prev_pos.copy_(positions[:, -1].repeat_interleave(k, dim=0))
    st.prev_token.copy_(last_prompt_token.to(dev, torch.int64)
                        .repeat_interleave(k, dim=0))
    st.finished.zero_()
    st.scores.fill_(float("-inf"))
    st.scores[:, 0] = 0.0
    clock.mark("prefill")
    for _ in range(t):
        st.program()
    out = {"tokens": st.tokens.clone(), "parents": st.parents.clone(),
           "hidden": st.hidden.clone(), "scores": st.scores.clone(),
           "finished": st.out_finished.clone()}
    clock.mark("decode")
    if timings is not None:
        timings["decode_forwards"] = t
    return out


def _backtrack_beam(out: Dict[str, torch.Tensor], gen_cfg: GenerationConfig,
                    batch_idx: int = 0):
    """Host side (reference generation.py:839-873): walk every final
    slot's parent pointers of ``generate_tokens_beam``'s output back into
    its token chain, score the chains under the HF length penalty
    (sum_logprob / len**alpha), and return the winner's (tokens [T] host
    int64, hidden [T, D], slot)."""
    tokens = out["tokens"][:, batch_idx].cpu().numpy()          # [T, K]
    parents = out["parents"][:, batch_idx].cpu().numpy()        # [T, K]
    scores = out["scores"][batch_idx].cpu().numpy()             # [K]
    t, k = tokens.shape

    def chain(final_slot):
        seq = np.zeros((t,), np.int64)
        hid_rows = np.zeros((t,), np.int64)
        slot = final_slot
        for i in range(t - 1, -1, -1):
            seq[i] = tokens[i, slot]
            hid_rows[i] = batch_idx * k + slot
            slot = int(parents[i, slot])
        return seq, hid_rows

    best, best_val = 0, -np.inf
    chains = []
    for slot in range(k):
        seq, hid_rows = chain(slot)
        eos = np.where(seq == gen_cfg.eos_token_id)[0]
        length = int(eos[0]) + 1 if eos.size else t
        val = float(scores[slot]) / max(length, 1) ** gen_cfg.length_penalty
        chains.append((seq, hid_rows))
        if val > best_val:
            best, best_val = slot, val

    seq, hid_rows = chains[best]
    dev = out["hidden"].device
    hidden = out["hidden"][torch.arange(t, device=dev),
                           torch.as_tensor(hid_rows, device=dev)]
    return seq, hidden, best


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
    """Batched generation: one prefill + decode loop for many prompts
    (beam search with ``gen_cfg.num_beams`` > 1).  Every request is a
    dict {"input_ids": list[int], "image_embeds": [N_i, T, vit_dim] or
    None, "embeds_cmp_mask": [N_i] bool or None, "ids_cmp_mask": [S_i]
    bool or None, "patch_positions": [N_i, 2] or None}.  Returns one
    result dict per request; without beams each carries the speculation
    counters ``spec_rounds`` and ``spec_accepted``."""
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
    mask_t = torch.as_tensor(mask, device=dev)
    if gen_cfg.num_beams > 1:
        bout = generate_tokens_beam(model, prompt_embeds, mask_t,
                                    last_tokens, gen_cfg, vocab,
                                    timings=timings)
        per_row = [_backtrack_beam(bout, gen_cfg, i)[:2] for i in range(b)]
        all_tokens = np.stack([r[0] for r in per_row])
        row_hidden = [r[1] for r in per_row]            # each [T, D]
    else:
        out = generate_tokens(model, prompt_embeds, mask_t, last_tokens,
                              gen_cfg, vocab, generator=generator,
                              timings=timings,
                              prompt_ids=torch.as_tensor(ids_padded))
        all_tokens = out["tokens"].cpu().numpy()
        row_hidden = list(out["hidden"])

    n_img = gen_cfg.num_img_gen_tokens
    rows, span_list = [], []
    for i in range(b):
        tokens, eoi_indices = _trim_and_spans(all_tokens[i], gen_cfg, vocab)
        rows.append((tokens, eoi_indices))
        span_list.extend((i, j) for j in eoi_indices)
    img_gen_all = None
    if span_list:
        spans = torch.stack([row_hidden[i][j - n_img:j]
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
    if gen_cfg.num_beams <= 1:
        # the speculation counters (a B = 1 feature, 0 when it is off)
        for r in results:
            r["spec_rounds"] = int(out["spec_rounds"])
            r["spec_accepted"] = int(out["spec_accepted"])
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
