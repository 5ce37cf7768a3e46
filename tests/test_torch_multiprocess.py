"""The port's two-process story (the counterpart of
tests/test_multiprocess.py): two CPU processes of
``tests/test_torch_multiproc_worker.py`` under torchrun's environment
(gloo over a free localhost port), each killed past its own time limit.

Both processes must print the same ``METRICS`` line (the global metrics
of two sharded train steps on fsdp 2) and the same ``MULTIPROC OK`` line
(a step after the checkpoint's save and restore across the process
boundary).  Then the checkpoint restores here, in one process on no mesh,
and its next step on the whole global batch matches rank 0's third step
to 1e-5 of each metric (fp32: the two ranks' gradients add in another
order than one process's).
"""

import json
import os
import socket
import subprocess
import sys

import torch

from seedx_tpu_torch.train.checkpoints import (CheckpointManager,
                                               restore_train_state)
from seedx_tpu_torch.train.train_sft import _to_device
from seedx_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                           make_train_step)

from test_torch_multiproc_worker import (TRAIN_KW, global_batch, metrics_of,
                                         tiny_agent)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_multiproc_worker.py")
TIMEOUT = 240          # seconds each process may take
REL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lines(out: str, tag: str):
    return [ln for ln in out.splitlines() if ln.startswith(tag)]


def test_two_processes_train_checkpoint_and_agree(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, RANK=str(pid), WORLD_SIZE="2",
                   LOCAL_RANK=str(pid), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    metrics = [_lines(o, "METRICS") for o in outs]
    oks = [_lines(o, "MULTIPROC OK") for o in outs]
    assert len(metrics[0]) == len(oks[0]) == 1, outs[0][-3000:]
    assert metrics[0] == metrics[1]
    assert oks[0] == oks[1]
    m1, m2 = json.loads(metrics[0][0].split(" ", 1)[1])
    assert m1["total_loss"] > 0 and m2["total_loss"] > 0

    # one process, no mesh: the checkpoint's next step on the whole batch
    agent = tiny_agent()
    cfg = TrainConfig(**TRAIN_KW)
    state = create_train_state(agent, cfg)
    restore_train_state(CheckpointManager(str(tmp_path / "ckpts")), state,
                        agent)
    assert state.step == 2
    got = metrics_of(make_train_step(agent, cfg)(
        state, _to_device(global_batch(), torch.device("cpu")),
        torch.Generator().manual_seed(3)))
    want = json.loads(oks[0][0].split(" ", 2)[2])
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= REL * max(abs(v), 1e-30), (k, got[k], v)
