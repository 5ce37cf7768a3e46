"""What the harness and the references load: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``seedx_tpu`` (compared whole:
``seedx_tpu_torch`` is the port), and the references nothing of the
port."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.harness import core

REF = os.path.join(core.BENCH, "reference")


def run_child(code: str):
    env = dict(os.environ, PYTHONPATH=core.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=core.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_compare_whole():
    assert core.forbidden_modules(["seedx_tpu_torch", "seedx_tpu_torch.ops",
                                   "numpy"]) == []
    assert core.forbidden_modules(["seedx_tpu.models.llama"]) == \
        ["seedx_tpu"]
    assert core.forbidden_modules(["jaxlib.xla_client", "flax"]) == \
        ["flax", "jaxlib"]


def test_a_run_loads_no_jax_package():
    got = run_child(
        "import json, sys\n"
        "from benchmark.harness import core\n"
        "from benchmark.tests import tiny\n"
        "tiny.run(tiny.agent_files(), seconds=1.0, trace=1)\n"
        "tiny.run(tiny.sdxl_files(), seconds=1.0, trace=1)\n"
        "tops = sorted({m.split('.', 1)[0] for m in sys.modules})\n"
        "print(json.dumps({'bad': core.forbidden_modules(), 'tops': tops}))\n")
    assert got["bad"] == []
    assert "seedx_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "seedx_tpu"} & set(got["tops"])


def test_the_references_load_nothing_of_the_program():
    got = run_child(
        "import json, sys, torch\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.reference import agent, sdxl\n"
        "cfg = tiny.agent_files()['config']\n"
        "agent.served_gaps(1, cfg, [{'ids': [1, 5, 6, 7], 'tokens': [9, 10],"
        " 'image': None, 'grid': None}], torch.device('cpu'))\n"
        "s = tiny.sdxl_files()['config']\n"
        "sdxl.resampler_xl(1, s, torch.zeros(1, 4, 128))\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    assert not {"seedx_tpu_torch", "seedx_tpu", "jax", "jaxlib",
                "flax"} & set(got)


def test_reference_sources_import_no_program():
    allowed = {"__future__", "contextlib", "math", "typing", "numpy", "torch", "PIL",
               "benchmark"}
    for path in glob.glob(os.path.join(REF, "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path, n)
                if n.startswith("benchmark"):
                    assert n in ("benchmark.harness.weights",
                                 "benchmark.reference.agent"), (path, n)
