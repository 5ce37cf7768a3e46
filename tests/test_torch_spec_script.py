"""``script_ids`` forcing, the adaptive gate over scripted streams and the
verify step as a predicated no-op: the port's ``generate_tokens`` against
the JAX package's, case for case with the script tests of
``tests/test_spec_decode.py`` (the agents and helpers of
``tests/test_torch_spec_decode.py``).  A script pins the emitted stream
while every forward still runs the model, so the counters of a scripted
run are a function of the script alone: they must equal JAX's and, with
the gate always on, a model-free replay of the drafting.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.models import generation as jgen
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.utils import graphs
from test_torch_spec_decode import (BUCKET, ECHO, N_IMG, TOK, VOCAB,  # noqa
                                    _cfgs, agents)

torch.set_num_threads(1)


# ---- script forcing ---------------------------------------------------------

def _run_script(agents, prompt_ids, script, **kw):
    """(port result with its decode info, JAX result) of generate_tokens
    with prompt_ids and script_ids at B = 1."""
    model_j, vars_j, agent_t = agents
    cfg_j, cfg_t = _cfgs(max_new_tokens=len(script), **kw)
    pad = BUCKET[0] - len(prompt_ids)
    ids_p = np.asarray([[TOK.pad_token_id] * pad + prompt_ids])
    mask = np.asarray([[False] * pad + [True] * len(prompt_ids)])
    want = jgen.generate_tokens(
        model_j, vars_j, model_j.apply(vars_j, jnp.asarray(ids_p, jnp.int32),
                                       method="embed_ids"),
        jnp.asarray(mask), jnp.asarray([prompt_ids[-1]], jnp.int32),
        jax.random.PRNGKey(0), cfg_j, VOCAB,
        prompt_ids=jnp.asarray(ids_p, jnp.int32),
        script_ids=jnp.asarray(script, jnp.int32))
    info = {}
    got = tgen.generate_tokens(
        agent_t, agent_t.embed_ids(torch.from_numpy(ids_p)),
        torch.from_numpy(mask), torch.tensor([prompt_ids[-1]]), cfg_t,
        VOCAB, timings=info, prompt_ids=torch.from_numpy(ids_p),
        script_ids=torch.tensor(script))
    assert got["tokens"][0].tolist() == list(script)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert int(got["spec_rounds"]) == int(want["spec_rounds"])
    assert int(got["spec_accepted"]) == int(want["spec_accepted"])
    return got, info


def replay_acceptance(prompt_ids, script, k=4, ngram=3, bucket=BUCKET[0]):
    """Always-on acceptance over a scripted stream, model-free (the
    ground truth the engine must reproduce)."""
    p, t = bucket, len(script)
    hist = torch.full((p + t,), -1, dtype=torch.int64)
    hist[p - len(prompt_ids):p] = torch.tensor(prompt_ids)
    n = rounds = accepted = 0
    while n < t:
        drafts = tgen._ngram_draft(hist, p + n, torch.tensor(script[n]), k,
                                   ngram).tolist()
        a = 0
        while a < k and n + 1 + a < t and drafts[a] == script[n + 1 + a]:
            a += 1
        hist[p + n:p + n + a + 1] = torch.tensor(script[n:n + a + 1])
        n += a + 1
        rounds, accepted = rounds + 1, accepted + a
    return rounds, accepted


def test_script_forcing_emits_script_plain(agents):
    ids = [TOK.bos_token_id] + TOK.encode("describe the scene")
    script = TOK.encode("a quick brown fox jumps over the lazy dog today")
    got, info = _run_script(agents, ids, script)
    assert int(got["spec_rounds"]) == 0
    assert info["decode_forwards"] == len(script)


def test_script_forcing_spec_emits_script_and_accepts_echo(agents):
    """spec_k 4 on an echoing script: the emitted stream is the script,
    and always-on (rounds, accepted) equal the model-free replay."""
    phrase = "the subscription renewals in the enterprise segment grew. "
    ids = [TOK.bos_token_id] + TOK.encode("[INST] " + phrase + "[/INST]")
    script = TOK.encode(phrase * 2)
    got, info = _run_script(agents, ids, script, spec_k=4,
                            spec_adaptive=False)
    rounds, accepted = replay_acceptance(ids, script)
    assert (int(got["spec_rounds"]), int(got["spec_accepted"])) == (
        rounds, accepted)
    assert accepted >= len(script) // 2
    assert info["decode_forwards"] == rounds
    got_ad, info_ad = _run_script(agents, ids, script, spec_k=4,
                                  spec_adaptive=True, spec_reprobe=12)
    assert int(got_ad["spec_accepted"]) > 0
    assert info_ad["gate_flips"] >= 1


def test_script_forcing_spec_gates_off_on_adversarial(agents):
    ids = [TOK.bos_token_id] + TOK.encode("list codes")
    script = TOK.encode(" ".join(f"zq{i}" for i in range(14)))[:40]
    got, info = _run_script(agents, ids, script, spec_k=4,
                            spec_adaptive=True, spec_probe_rounds=4,
                            spec_reprobe=48)
    assert int(got["spec_accepted"]) == 0
    assert int(got["spec_rounds"]) <= 8
    # the gate flips at the probe's last round: no verify replay is spent
    # past it (the windows end where the gate decides)
    assert info["verify_replays"] == int(got["spec_rounds"])
    assert info["plain_replays"] == len(script) - int(got["spec_rounds"])


def test_script_forcing_gate_recovers_after_cooldown(agents):
    """Gated-off plain steps must extend the history: the re-probe after
    the cooldown drafts from the echo's first occurrence they emitted."""
    ids = [TOK.bos_token_id] + TOK.encode("write the report")
    junk = TOK.encode(" ".join(f"xk{i}" for i in range(8)))[:20]
    phrase = TOK.encode("metric alpha beta gamma delta rose sharply again. ")
    script = list(junk) + list(phrase) * 3
    got, info = _run_script(agents, ids, script, spec_k=4,
                            spec_adaptive=True, spec_probe_rounds=4,
                            spec_reprobe=12)
    assert int(got["spec_accepted"]) >= len(phrase)
    assert info["gate_flips"] >= 2


# ---- the verify step as a predicated no-op ----------------------------------

class _KeptOnCPU(graphs.Graphs):
    """Keeps the agent's decode states (their programs still run eagerly
    on the CPU)."""

    def active(self, device):
        return True


def _snapshot(st):
    return ({k: v.clone() for k, v in vars(st).items()
             if torch.is_tensor(v)}, [c.clone() for c in st.cache])


def _unchanged(st, snap):
    tensors, cache = snap
    for k, v in tensors.items():
        assert torch.equal(getattr(st, k), v), k
    for a, b in zip(st.cache, cache):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["n_reached_t", "chunkable_img",
                                  "gate_off"])
def test_verify_step_is_a_predicated_no_op(agents, monkeypatch, case):
    """The verify step changes no output, counter, history or cache cell
    (its writes dropped) when decode has stopped, sits at a chunkable
    ``<img>``, or the gate is off; the plain step likewise while the gate
    is on.  A live verify step on the same state does change it."""
    _, _, agent_t = agents
    vars(agent_t).pop("decode_programs", None)
    monkeypatch.setattr(agent_t, "graphs", _KeptOnCPU())
    try:
        ids = [TOK.bos_token_id] + TOK.encode(ECHO)
        script = TOK.encode(ECHO * 2)[:N_IMG + 4]
        _run_script(agents, ids, script, spec_k=4, spec_adaptive=False,
                    num_img_gen_tokens=N_IMG)
        (st,) = tgen.decode_programs(agent_t).states.values()
        cfg = st.gen_cfg
        if case != "n_reached_t":
            st.n.fill_(3)
            st.finished.zero_()
        if case == "chunkable_img":
            st.prev_token.fill_(VOCAB.boi)
        st.sp[5] = 0 if case == "gate_off" else 1
        st.set_flags(cfg, VOCAB)
        snap = _snapshot(st)
        st.spec_program()
        _unchanged(st, snap)
        if case == "gate_off":
            st.sp[5] = 1
            st.set_flags(cfg, VOCAB)
            snap = _snapshot(st)
            st.program()                     # the plain step, gate on
            _unchanged(st, snap)
            st.spec_program()
            assert int(st.n) > 3 and int(st.forwards) == snap[0][
                "forwards"] + 1
    finally:
        vars(agent_t).pop("decode_programs", None)
