"""A configuration, a traffic mix, a kind of mix (its loop), a per-layer
metric and a cell's limits, dropped into a copy of the benchmark as new
files with their entries in BENCHMARK.json (the training rate's entry taken
from `parked.json`, as a change that brings training cells back would), are
found by name, and a run of the new cell goes through, with no other file
edited."""

import hashlib
import json
import pathlib
import shutil

import torch

from benchmark.harness import manifest, runner
from benchmark.tests import _tiny

NEW_CELL = "train_once.joystick_copy"
READER = '''"""The update's share of a training step, in %."""


def read(obs):
    t = obs["timed"]
    return 100.0 * t["update_s"] / t["step_s"] if t.get("step_s") else None
'''


def _digests(root: pathlib.Path):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_editing_any(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench)

    config = json.loads((bench / "configs" / "joystick_flat_backlash.json").read_text())
    config["name"] = "joystick_copy"
    (bench / "configs" / "joystick_copy.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "train.json").read_text())
    traffic["loop"] = "train_copy"
    shutil.copy(bench / "harness" / "loops" / "train.py", bench / "harness" / "loops" / "train_copy.py")
    (bench / "traffic" / "train_once.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "update_share.train_once.py").write_text(READER)
    limits = json.loads((bench / "limits" / "train.joystick_flat_backlash.json").read_text())
    (bench / "limits" / f"{NEW_CELL}.json").write_text(json.dumps(limits))

    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "joystick_copy", "source": "https://example.org/joystick_copy",
                           "file": "benchmark/configs/joystick_copy.json", "reduced": [], "why": "a test"})
    man["workloads"].append({"name": NEW_CELL, "config": "joystick_copy", "traffic": "train_once", "chips": 1,
                             "why": "a test"})
    parked = json.loads((bench / "parked.json").read_text())
    rate = next(m for m in parked["end_to_end"] if m["name"] == "train_env_steps_per_s")
    man["end_to_end"].append({**rate, "workloads": [NEW_CELL]})
    man["per_layer"].append({"name": "update_share.train_once", "unit": "%", "better": "lower",
                             "source": "program_span", "layer": "update (ppo SGD steps)",
                             "moves": "train_env_steps_per_s", "workloads": [NEW_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    loaded = manifest.load(bench)
    cell = manifest.cell(loaded, NEW_CELL)
    assert [m["name"] for m in cell["per_layer"]] == ["update_share.train_once"]
    read = manifest.metric_reader(bench, "update_share.train_once")
    assert read({"timed": {"update_s": 0.8, "step_s": 1.0}}) == 80.0
    _, cfg, mix, lim = runner.prepare(NEW_CELL, bench)
    assert cfg["name"] == "joystick_copy" and mix["loop"] == "train_copy" and lim == limits["numbers"]
    assert manifest.loop_class(bench, "train_copy").__module__ == "benchmark_loop_train_copy"

    torch.set_num_threads(2)
    ppo, mix_small = _tiny.TRAIN_PPO, _tiny.TRAIN_TRAFFIC
    result = runner.run(NEW_CELL, _tiny.SEED, 0.0, False, bench_dir=bench, device="cpu",
                        config_overrides=ppo, traffic_overrides=mix_small, need_card=False)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "train_env_steps_per_s"}

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
