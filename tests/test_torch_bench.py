"""The port's three bench tools, run on the CPU at toy sizes through their
`main(argv, device="cpu")`: each prints its JSON record last, in the form
of the JAX package's tool (`bench.py:100-108`, `tools/bench_physics.py`,
`tools/bench_ppo_sustained.py:76-94`), with no TPU baseline in it. The
rates are of the CPU's plain engine and mean nothing; the card's are in
PERF.md. Without `device="cpu"` a tool refuses to run where there is no
card.
"""

import json

import pytest
import torch

from open_duck_playground_torch.tools import bench_physics, bench_ppo_sustained, bench_rollout

torch.set_num_threads(1)

TOY_PPO = ["num_envs=8", "batch_size=4", "num_minibatches=2", "unroll_length=4", "num_updates_per_batch=1",
           "episode_length=6", "num_eval_envs=4", "num_evals=3",
           "network_factory={'policy_hidden_layer_sizes': (8,), 'value_hidden_layer_sizes': (8,)}"]


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_rollout_prints_bench_py_record(capsys):
    record = bench_rollout.main(["--envs", "8", "--steps", "2", "--reps", "2"], device="cpu")
    printed = last_json(capsys)
    assert printed == record
    assert set(record) == {"metric", "value", "unit", "device"} and "vs_baseline" not in record
    assert record["metric"] == "env_steps_per_sec@8envs" and record["unit"] == "env_steps/s"
    assert record["value"] > 0 and record["device"] == "cpu"


@pytest.mark.parametrize("task", ["flat_terrain_backlash", "rough_terrain_backlash", "flat_terrain_no_head"])
def test_bench_physics_prints_text_and_json(capsys, task):
    record = bench_physics.main(["--task", task, "--envs", "8", "--steps", "2"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith(f"task={task} envs=8: ") and lines[-2].endswith("env-steps/s (physics only)")
    assert json.loads(lines[-1]) == record
    assert record["metric"] == "physics_env_steps_per_sec@8envs" and record["unit"] == "env_steps/s"
    assert record["value"] > 0 and record["ms_per_launch"] > 0 and record["finite"]
    # on the CPU forward.step is the plain engine: no kernel launch
    assert record["kernel_launches"] == 0 and record["steps"] == 2 and record["reps"] == 3


def test_bench_ppo_sustained_record_has_the_jax_keys(capsys, tmp_path):
    """Two periods of one training step (32 env steps each) after the
    initial eval: the record holds both, the first as warm-up, each with
    its eval reward; `value` is the second period's rate."""
    argv = ["--timesteps", "64", "--json_out", str(tmp_path / "r.json")]
    for pair in TOY_PPO:
        argv += ["--config_override", pair]
    record = bench_ppo_sustained.main(argv, device="cpu")
    assert last_json(capsys) == record == json.loads((tmp_path / "r.json").read_text())
    jax_keys = {"metric", "value", "unit", "n_chips", "task", "timesteps", "bf16_matmuls", "chunks"}
    assert jax_keys <= set(record) and "vs_baseline" not in record
    assert record["metric"] == "sustained_ppo_env_steps_per_sec_per_chip" and record["n_chips"] == 1
    chunks = record["chunks"]
    assert [(c["steps"], c["warmup"]) for c in chunks] == [(32, True), (32, False)]
    assert all(isinstance(c["eval_episode_reward"], float) for c in chunks)
    assert isinstance(record["initial_eval_episode_reward"], float)
    assert record["value"] == pytest.approx(32 / chunks[1]["seconds"], rel=1e-2, abs=1)


def test_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (bench_rollout, bench_physics, bench_ppo_sustained):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main([])
