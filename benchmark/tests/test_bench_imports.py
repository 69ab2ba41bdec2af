"""No module a benchmark run loads has the top-level name `jax`, `jaxlib`,
`flax` or `open_duck_playground_tpu` (compared whole: the port's own name
begins with the JAX package's), and the reference imports nothing of the
port."""

import ast
import json
import pathlib
import subprocess
import sys

from benchmark.harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "open_duck_playground_tpu"}
LOAD_ALL = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import importlib
from benchmark.harness import check, inputs, manifest, port, runner, trees
import benchmark.calibrate, benchmark.run
from benchmark.metrics import _kernel_work, _peaks, _step_work, _trace
port.modules()
man = manifest.load(parked=True)
for m in man["per_layer"]:
    manifest.metric_reader(manifest.BENCH_DIR, m["name"])
for w in man["workloads"]:
    _, config, traffic, _ = runner.prepare(w["name"])
    manifest.loop_class(manifest.BENCH_DIR, traffic["loop"])
    importlib.import_module("open_duck_playground_torch.envs." + config["env"])
    inputs.reference_task_module(config)
port.classes()
from benchmark.reference.envs import duck_base, env_types, gait_oracle, imitation, joystick, randomize, rewards, standing, wrappers
from benchmark.reference.physics import forward
from benchmark.reference.train import gae, ppo, running_stats
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""


def _top_level_imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL, str(manifest.ROOT)], capture_output=True, text=True,
                         check=True, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "open_duck_playground_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((manifest.BENCH_DIR / "reference").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        names = set(_top_level_imports(path))
        assert not names & (FORBIDDEN | {"open_duck_playground_torch"}), (path, names)


def test_the_harness_and_metrics_import_no_jax():
    for path in sorted(manifest.BENCH_DIR.rglob("*.py")):
        assert not set(_top_level_imports(path)) & FORBIDDEN, path
