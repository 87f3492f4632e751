"""The harness loads nothing of JAX or of the JAX package, and the
references load nothing of the program (top-level names compared
whole: the port's name begins with the JAX package's)."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "smartdenovo_tpu"}


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PRINT = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))")


def test_harness_loads_no_jax():
    code = (
        "import sys, runpy; sys.path.insert(0, '.');"
        "runpy.run_path('portbench/run.py', run_name='portbench_run');"
        "from portbench.harness import bench, stages, trace, window;"
        "b = bench.load_benchmark();"
        "[bench.metric_reader(m['name']) for m in b['per_layer']];"
        "[bench.roofline(k) for k in bench.roofline_kernels()];"
        "[bench.unit_kind(json.load(open(f'portbench/traffic/{t}.json')))"
        " for t in {w['traffic'] for w in b['workloads']}];"
        "import smartdenovo_tpu_torch.pipeline.zmo, "
        "smartdenovo_tpu_torch.pipeline.cns;"
        "import portbench.reference.overlap_ref, "
        "portbench.reference.cns_judge;" + PRINT).replace(
            "import sys, runpy", "import json, sys, runpy")
    names = _top_level(code)
    assert "smartdenovo_tpu_torch" in names and "portbench" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level(
        "import sys; sys.path.insert(0, '.');"
        "import portbench.reference.overlap_ref, "
        "portbench.reference.cns_judge, portbench.gen.workload;" + PRINT)
    assert not names & (FORBIDDEN | {"smartdenovo_tpu_torch"})
