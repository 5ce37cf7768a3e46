"""The serving driver's look inside ``ContinuousEngine`` goes through one
adapter, which refuses an engine that no longer has what it reads; the
program's precision follows its configuration, and the references give
back the flags they change."""

import pytest
import torch

from benchmark.harness import core
from benchmark.harness.engine import EngineChanged, EngineProbe
from benchmark.harness.programs import set_precision, stated_dtypes
from benchmark.reference.agent import plain_precision


class Renamed:
    """An engine whose private fields went by other names."""

    def __init__(self):
        self.pending, self.results = [], {}

    def _admit_pending(self):
        pass


def test_probe_refuses_an_engine_it_cannot_read():
    with pytest.raises(EngineChanged) as e:
        EngineProbe(Renamed())
    msg = str(e.value)
    assert "_pending" in msg and "_results" in msg
    assert "_prefill_group" in msg and "_admit_pending" not in msg


def test_probe_reads_and_takes_results():
    class Engine(Renamed):
        def __init__(self):
            self._pending = [(3, {}, 8), (4, {}, 8)]
            self._results = {1: {"tokens": [5]}}

        def _prefill_group(self, requests, bucket):
            pass

    eng = Engine()
    probe = EngineProbe(eng)
    assert probe.waiting() == {3, 4}
    assert probe.take_results() == {1: {"tokens": [5]}}
    assert eng._results == {}


@pytest.mark.parametrize("cell", ["ds7b_longdoc_serve", "sdxl_t2i_1024"])
def test_program_precision_from_the_configuration(cell):
    cfg = core.cell_files(cell)["config"]
    assert stated_dtypes(cfg) <= {"bfloat16", "float32"}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    set_precision(cfg)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    set_precision(dict(cfg, torch_dtype="tf32"))
    assert torch.backends.cuda.matmul.allow_tf32
    set_precision(cfg)


def test_references_give_the_flags_back():
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    with plain_precision():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = cudnn
