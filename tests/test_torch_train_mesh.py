"""Training on a mesh (``train/trainer.py``, ``train/checkpoints.py``,
``data/pipeline.process_rank``): the tiny agent's sharded train steps on
gloo ranks against the unsharded port and against the JAX package's
``make_train_step`` on the 8-device virtual mesh (``tests/conftest.py``).

The ranks are processes of ``tests/test_torch_shard_worker.py`` (torch and
the port only), started by ``test_torch_sharding._start``: each passes its
rows of one global batch (B 4, S 64, one image a row, rows holding 10 to
58 valid labels).  The tiny agent is the JAX two-process worker's (hidden
128, 2 layers, 4 heads, LoRA r8, 4 image tokens), fp32, with its weights
drawn from a seed.  Layouts (data, fsdp, tensor): fsdp 4, data 2 x
fsdp 2 and fsdp 2 x tensor 2, two steps each, with LoRA dropout on (rate
0.1, the unsharded step's masks, drawn from the same generator) and
with dropout 0.

Tolerances (fp32 both sides): the losses and the grad norm within 1e-5 of
their value, against the unsharded port and against JAX; every trainable
leaf after each step within 2e-5 of the leaf's scale (AdamW divides by
the gradient's root mean square, so a gradient summed in another order
moves a leaf by a few ulps of the learning rate).  The three mutants miss
by far more: a mean of the ranks' means (a different loss, since the
ranks hold different label counts), no all-reduce of dx at a
column-parallel input (partial gradients upstream at tensor 2), and an
fsdp gather with no backward (no gradient for the leaves it gathers).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.models import agent as jagent
from seedx_tpu.models.llama import llama_debug as jllama_debug
from seedx_tpu.parallel import mesh as jmesh
from seedx_tpu.train import train_sft as jtrain_sft
from seedx_tpu.train import trainer as jtrainer
from seedx_tpu_torch.parallel import mesh as tmesh
from seedx_tpu_torch.train import checkpoints as tckpt
from seedx_tpu_torch.train import trainer as ttrainer

from test_torch_shard_worker import (TRAIN_KW, batch_rows, tiny_train_agent,
                                     torch_batch)
from test_torch_sharding import _join, _start
from torch_train_fixtures import jax_tree, random_state

torch.set_num_threads(1)

LLM = dict(hidden_size=128, intermediate_size=256, num_layers=2,
           num_heads=4, num_kv_heads=4, lora_rank=8, lora_dropout=0.1)
AGENT = dict(vit_dim=64, resampler_heads=4, num_img_in_tokens=4,
             num_img_out_tokens=4)
CFG = json.dumps({"llm": LLM, "agent": AGENT})
STEPS = 2
LOSS_REL = 1e-5
LEAF_REL = 2e-5
LAYOUTS = {"fsdp4": (1, 4, 1), "data2_fsdp2": (2, 2, 1),
           "fsdp2_tensor2": (1, 2, 2)}
MUTANTS = {"fsdp4": ("mean_of_means", "no_gather_grad"),
           "data2_fsdp2": (), "fsdp2_tensor2": ("no_f",)}


def global_batch():
    """B 4, S 64, 4 images of 16 tokens (pooled to 4 targets): rows 0-1
    comprehension spans, rows 2-3 generation spans; row r's first 4 + 16 r
    labels ignored and row 3 padded, so the ranks hold different numbers
    of valid labels."""
    rng = np.random.default_rng(7)
    b, s, n, t = 4, 64, 4, 16
    ids = rng.integers(5, 30000, (b, s)).astype(np.int32)
    attn = np.ones((b, s), bool)
    attn[3, 52:] = False
    labels = np.where(attn, ids, -100).astype(np.int32)
    for r in range(b):
        labels[r, :4 + 16 * r] = -100
    ids_cmp = np.zeros((b, s), bool)
    ids_cmp[0, 1:5] = ids_cmp[1, 3:7] = True
    ids_gen = np.zeros((b, s), bool)
    ids_gen[2, 2:6] = ids_gen[3, 5:9] = True
    return dict(input_ids=ids, attention_mask=attn, labels=labels,
                image_embeds=(0.1 * rng.standard_normal((n, t, 64))).astype(
                    np.float32),
                embeds_gen_mask=np.array([False, False, True, True]),
                embeds_cmp_mask=np.array([True, True, False, False]),
                ids_gen_mask=ids_gen, ids_cmp_mask=ids_cmp,
                patch_positions=rng.random((n, 2)).astype(np.float32))


def _inputs(layout, runs, state, batch):
    inp = {"cfg": np.array(CFG), "mesh": np.array(layout),
           "runs": np.array(json.dumps(runs))}
    inp.update({f"state/{k}": v for k, v in state.items()})
    inp.update({f"batch/{k}": v for k, v in batch.items()})
    return inp


def port_steps(state, batch, dropout: bool, steps: int = STEPS):
    """The unsharded port: (metrics of each step, {leaf: value} after
    each step)."""
    agent = tiny_train_agent(CFG, state)
    cfg = ttrainer.TrainConfig(**TRAIN_KW)
    st = ttrainer.create_train_state(agent, cfg)
    step = ttrainer.make_train_step(agent, cfg)
    metrics, leaves = [], []
    for _ in range(steps):
        gen = (torch.Generator().manual_seed(1000 + st.step) if dropout
               else None)
        metrics.append(step(st, torch_batch(batch), gen))
        leaves.append({n: p.detach().numpy().copy()
                       for n, p in st.params.items()})
    return metrics, leaves


def jax_steps(state, batch, layout, steps: int = STEPS):
    """The JAX package's train step, dropout 0, on the virtual mesh of
    ``layout``: every leaf placed by its logical axes, the batch by
    ``train_sft._to_device``.  (metrics, {port leaf name: value})."""
    llm = dict(LLM, lora_dropout=0.0)
    model = jagent.ContinuousLVLM(jagent.AgentConfig(
        llm=jllama_debug(dtype=jnp.float32, remat=False, **llm),
        dtype=jnp.float32, **AGENT))
    n = int(np.prod(layout))
    mesh = jmesh.create_mesh(*layout, devices=jax.devices()[:n])
    axes = tmesh.logical_axes(tiny_train_agent(CFG))
    with mesh:
        placed = {k: jax.device_put(v, jmesh.mesh_sharding(mesh, *axes[k]))
                  for k, v in state.items()}
        cfg = jtrainer.TrainConfig(**TRAIN_KW)
        st, frozen = jtrainer.create_train_state(jax_tree(placed), cfg)
        step = jtrainer.make_train_step(model, cfg)
        dbatch = jtrain_sft._to_device(batch, mesh)
        metrics, leaves = [], []
        for i in range(steps):
            st, m = step(st, frozen, dbatch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
            flat = {}
            for path, v in jax.tree_util.tree_leaves_with_path(
                    st.trainable):
                name = ".".join(str(getattr(p, "key", p)) for p in path)
                name = name.replace("llm.model.layers.layer.",
                                    "llm.layers.").replace(
                    "llm.model.norm.", "llm.norm.")
                flat[name] = np.asarray(v)
            leaves.append(flat)
    return metrics, leaves


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every layout's gloo run, started together, and the references
    computed while they run."""
    state = random_state(tiny_train_agent(CFG), 21)
    batch = global_batch()
    root = tmp_path_factory.mktemp("train_mesh")
    ckpt = str(root / "ckpt")
    runs = {}
    for name, layout in LAYOUTS.items():
        spec = [{"steps": STEPS, "dropout": True},
                {"steps": STEPS, "dropout": False}]
        spec += [{"steps": 1, "dropout": False, "mutant": m}
                 for m in MUTANTS[name]]
        if name == "fsdp2_tensor2":
            spec[1]["save"] = ckpt
        runs[name] = _start("train", int(np.prod(layout)), root,
                            _inputs(layout, spec, state, batch), name)
    ref = {"dropout": port_steps(state, batch, True),
           "plain": port_steps(state, batch, False)}
    want_j = {name: jax_steps(state, batch, layout)
              for name, layout in LAYOUTS.items()}
    outs = {name: _join(run) for name, run in runs.items()}
    # the checkpoint of the fsdp 2 x tensor 2 run, restored on fsdp 2
    restore = _start("train", 2, root, _inputs(
        (1, 2, 1), [{"steps": 1, "dropout": False, "restore": ckpt}], state,
        batch), "restore")
    outs["restore"] = _join(restore)
    return state, batch, ref, want_j, outs, ckpt


def _metrics(out, run):
    return json.loads(str(out[f"run{run}/metrics"]))


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err,
                                                        np.abs(want).max())


def _check_steps(outs, run, metrics, leaves):
    """Every rank's metrics; the whole leaves, which the first rank
    keeps."""
    for out in outs:
        got = _metrics(out, run)
        for i, (m, want) in enumerate(zip(got, metrics)):
            for k in ("total_loss", "lm_loss", "rec_loss", "grad_norm"):
                _close(m[k], want[k], LOSS_REL, f"step {i} {k}")
    for i in range(len(metrics)):
        for n, v in leaves[i].items():
            _close(outs[0][f"run{run}/leaf{i}/{n}"], v, LEAF_REL,
                   f"step {i} {n}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_steps_match_the_unsharded_port_with_dropout(mesh_runs,
                                                             layout):
    """Losses, grad norm and every trainable leaf after each of two steps
    with LoRA dropout on: each rank keeps its rows of the unsharded
    step's masks; every rank reports the global metrics."""
    _, _, ref, _, outs, _ = mesh_runs
    _check_steps(outs[layout], 0, *ref["dropout"])
    for out in outs[layout]:
        assert _metrics(out, 0) == _metrics(outs[layout][0], 0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_steps_match_jax_sharded_steps(mesh_runs, layout):
    """Dropout 0: the port's sharded steps against the JAX package's
    ``make_train_step`` on the virtual mesh at the same layout (and the
    unsharded port against the same)."""
    _, _, ref, want_j, outs, _ = mesh_runs
    metrics_j, leaves_j = want_j[layout]
    _check_steps(outs[layout], 1, *ref["plain"])
    _check_steps(outs[layout], 1, metrics_j, leaves_j)


@pytest.mark.parametrize("layout,mutant", [(k, m) for k, ms in
                                           MUTANTS.items() for m in ms])
def test_training_mutants_fail(mesh_runs, layout, mutant):
    """Each mutant's first step misses the unsharded port's by more than
    the tolerance: a mean of the ranks' means, no "f" backward at
    tensor 2, no reduce-scatter behind an fsdp gather."""
    _, _, ref, _, outs, _ = mesh_runs
    run = 2 + MUTANTS[layout].index(mutant)
    with pytest.raises(AssertionError):
        _check_steps(outs[layout], run, ref["plain"][0][:1],
                     ref["plain"][1][:1])


def test_global_loss_is_not_a_mean_of_means(mesh_runs):
    """The batch the tests use gives the ranks different label counts, so
    the global mean and the mean of the ranks' means differ."""
    _, batch, _, _, _, _ = mesh_runs
    valid = (batch["labels"][:, 1:] != -100).sum(1)
    assert len(set(valid.tolist())) == 4


def test_checkpoint_restores_on_any_layout(mesh_runs):
    """Written on fsdp 2 x tensor 2 after two steps: the file holds the
    whole trainable leaves (no frozen leaf); restored on one rank (here)
    and on fsdp 2 (gloo ranks), equal leaf for leaf; the restored states'
    next steps agree with each other."""
    state, batch, _, _, outs, ckpt = mesh_runs
    saved = tckpt.CheckpointManager(ckpt).restore()
    agent = tiny_train_agent(CFG, state)
    cfg = ttrainer.TrainConfig(**TRAIN_KW)
    st = ttrainer.create_train_state(agent, cfg)
    assert set(saved["trainable"]) == set(st.params)
    frozen = set(agent.state_dict()) - set(st.params)
    assert frozen and not frozen & set(saved["trainable"])
    written = outs["fsdp2_tensor2"][0]
    for n in st.params:
        np.testing.assert_array_equal(saved["trainable"][n].numpy(),
                                      written[f"run1/leaf1/{n}"])
    tckpt.restore_train_state(tckpt.CheckpointManager(ckpt), st, agent)
    assert st.step == STEPS
    for n, p in st.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      written[f"run1/leaf1/{n}"])
        for k in ("mu", "nu"):
            np.testing.assert_array_equal(st.opt_state[k][n].numpy(),
                                          saved["opt_state"][k][n].numpy())
    for out in outs["restore"]:
        assert int(out["run0/restored_step"]) == STEPS
    restored = outs["restore"][0]          # the first rank keeps them
    for n in st.params:
        np.testing.assert_array_equal(restored[f"run0/restored/{n}"],
                                      written[f"run1/leaf1/{n}"])
    m = ttrainer.make_train_step(agent, cfg)(st, torch_batch(batch))
    got = _metrics(outs["restore"][0], 0)[0]
    for k in ("total_loss", "grad_norm"):
        _close(got[k], m[k], LOSS_REL, k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_data_follows_the_batch_coordinate(mesh_runs, layout):
    """``shard_files`` and ``weighted_mix`` on a mesh: tensor peers read
    the same files and the same mixed stream; the batch ranks' file
    shards are disjoint and cover every file."""
    outs = mesh_runs[4][layout]
    data, fsdp, tensor = LAYOUTS[layout]
    files, mixes = {}, {}
    for r, out in enumerate(outs):
        coord = r // tensor
        got = json.loads(str(out["files"]))
        mix = json.loads(str(out["mix"]))
        assert files.setdefault(coord, got) == got
        assert mixes.setdefault(coord, mix) == mix
    assert len(files) == data * fsdp
    every = sorted(f for fs in files.values() for f in fs)
    assert every == sorted(f"f{i}" for i in range(8))
    if len(mixes) > 1:
        assert mixes[0] != mixes[1]


def test_batch_rows_split_the_global_batch():
    batch = global_batch()
    parts = [batch_rows(batch, i, 4) for i in range(4)]
    for k, v in batch.items():
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]),
                                      v)
