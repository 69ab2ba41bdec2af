"""The port's training CLI against the JAX package's.

- `parse_overrides` reads the same values from a list of `KEY=VALUE` pairs,
  and the routing sends the same keys to the PPO config and to the env
  (JAX `cli/runner.py:75-86`).
- The env config takes the routed overrides as the JAX ConfigDict does:
  the same values, KeyError on an unknown key, TypeError on a float for an
  int; every option of the JAX config is there (`rsi_prob`,
  `head_direct_targets` included).
- `main([...], device="cpu")` at a tiny config writes a `<date>_<step>`
  checkpoint directory and an .onnx file per eval, and a run resumed from
  the last checkpoint continues `env_steps`, Adam's step and the generator.
- The CLI trains with domain randomization, as the JAX runner asks for it
  (`randomization_fn=self.randomizer`), and evaluates on the nominal model.
"""

import dataclasses
import json

import pytest
import torch
from ml_collections import config_dict

from open_duck_playground_tpu.cli import runner as JR
from open_duck_playground_tpu.envs import joystick as JJ
from open_duck_playground_tpu.envs import standing as JS
from open_duck_playground_tpu.train.config import ppo_config as jax_ppo_config

from open_duck_playground_torch.cli import runner
from open_duck_playground_torch.envs import duck_base
from open_duck_playground_torch.envs.joystick import JoystickConfig
from open_duck_playground_torch.envs.standing import StandingConfig
from open_duck_playground_torch.export.onnx_runtime import OnnxPolicy
from open_duck_playground_torch.train import checkpoint as CKPT

torch.set_num_threads(1)

PAIRS = [
    "num_evals=3",
    "learning_rate=1e-3",
    "max_grad_norm=None",
    "bf16_matmuls=True",
    "network_factory={'policy_hidden_layer_sizes': (64, 64)}",
    "seed=3",
    "num_timesteps=10",
    "reward_config.scales.tracking_lin_vel=4",  # the joystick task's
    "push_config.magnitude_range=[0.1,0.5]",
    "noise_config.level=0.5",
    "noise_config.scales.gyro=0.2",
    "head_range_factor=0.8",
    "name=plain string",
]


def jax_routing(overrides):
    """JAX cli/runner.py:79-85, which lives inside Runner.__init__."""
    ppo_overrides = {}
    ppo_fields = set(jax_ppo_config()) - {"num_timesteps", "seed"}
    for k in [k for k in overrides if k in ppo_fields]:
        ppo_overrides[k] = overrides.pop(k)
    return ppo_overrides, overrides or None


def test_overrides_parse_and_route_like_jax():
    want = JR.parse_overrides(PAIRS)
    got = runner.parse_overrides(PAIRS)
    assert got == want and got["name"] == "plain string" and got["max_grad_norm"] is None
    assert runner.parse_overrides(None) is None is JR.parse_overrides(None)
    with pytest.raises(ValueError):
        runner.parse_overrides(["no_equals_sign"])
    assert runner.split_overrides(got) == jax_routing(dict(want))
    assert runner.PPO_KEYS == set(jax_ppo_config()) - {"num_timesteps", "seed"}
    ppo_overrides, _ = runner.split_overrides(got)
    cfg = runner.ppo_config(num_timesteps=7, seed=1, **ppo_overrides)
    assert (cfg.num_evals, cfg.learning_rate, cfg.max_grad_norm, cfg.policy_hidden_layer_sizes,
            cfg.value_hidden_layer_sizes, cfg.num_timesteps, cfg.seed) == (
        3, 1e-3, None, (64, 64), (256, 256, 256, 256), 7, 1)


def _as_plain(x):
    if isinstance(x, config_dict.ConfigDict):
        return {k: _as_plain(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: _as_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_plain(v) for v in x]
    return x


@pytest.mark.parametrize("task_env", ["joystick", "standing"])
def test_env_overrides_take_like_the_config_dict(task_env):
    jcfg, tcfg = ((JJ.default_config(), JoystickConfig()) if task_env == "joystick"
                  else (JS.default_config(), StandingConfig()))
    jcfg = jcfg.lock()
    pairs = PAIRS[8:-1] + (["reward_config.scales.tracking_lin_vel=4", "use_imitation=False", "rsi_prob=0.5",
                            "head_direct_targets=True"]
                           if task_env == "joystick" else ["reward_config.scales.head_pos=-1", "head_pos_ungated=True",
                                                           "head_direct_targets=True"])
    _, env_overrides = runner.split_overrides(runner.parse_overrides(pairs))
    jcfg.update_from_flattened_dict(env_overrides)
    tcfg = duck_base.override_config(tcfg, env_overrides)
    want = _as_plain(jcfg)
    assert want == _as_plain(tcfg)
    assert tcfg.head_direct_targets is True
    if task_env == "joystick":
        assert tcfg.rsi_prob == 0.5 and isinstance(tcfg.rsi_prob, float)
    for bad, error in (({"bogus": 1}, KeyError), ({"reward_config.scales.bogus": 1.0}, KeyError),
                       ({"noise_config.action_max_delay": 2.5}, TypeError)):
        with pytest.raises(error):
            jcfg.update_from_flattened_dict(bad)
        with pytest.raises(error):
            duck_base.override_config(tcfg, bad)
    with pytest.raises(TypeError):  # a bool option takes no number
        duck_base.override_config(tcfg, {"head_direct_targets": 1})


TINY = ["num_envs=8", "batch_size=4", "num_minibatches=2", "unroll_length=4", "num_updates_per_batch=1",
        "episode_length=6", "num_eval_envs=4",
        "network_factory={'policy_hidden_layer_sizes': (8,), 'value_hidden_layer_sizes': (8,)}"]


def _main(out, *args):
    argv = ["--task", "flat_terrain_backlash", "-o", str(out)]
    for pair in TINY:
        argv += ["--config_override", pair]
    return runner.main(argv + list(args), device="cpu")


def _saved(out):
    return sorted((p for p in out.iterdir() if p.is_dir()), key=lambda p: int(p.name.rsplit("_", 1)[1]))


def test_main_writes_a_checkpoint_and_onnx_per_eval_and_resumes(tmp_path, capsys):
    out = tmp_path / "run"
    make_policy, (normalizer, net), metrics = _main(out, "--num_timesteps", "32",
                                                    "--config_override", "num_evals=2")
    dirs = _saved(out)
    assert [int(p.name.rsplit("_", 1)[1]) for p in dirs] == [0, 32]  # initial eval, one step of 32
    for d in dirs:
        assert (d / CKPT.STATE_FILE).is_file() and (out / f"{d.name}.onnx").is_file()
        assert len(d.name.split("_")) == 5  # YYYY_MM_DD_HHMMSS_step
    assert "STEP: 32 reward:" in capsys.readouterr().out
    raw = CKPT.restore(dirs[-1])
    assert raw["env_steps"] == 32 and all(float(s["step"]) == 2 for s in raw["opt_state"]["state"].values())
    obs = torch.randn(5, normalizer.mean["state"].shape[0], generator=torch.Generator().manual_seed(0))
    want = make_policy((normalizer, net), deterministic=True)({"state": obs})[0]
    got = OnnxPolicy(str(out / f"{dirs[-1].name}.onnx")).infer(obs.numpy())
    torch.testing.assert_close(torch.as_tensor(got), want, rtol=0, atol=1e-5)
    assert all(k.startswith("training/") for k in metrics)

    _main(tmp_path / "resumed", "--num_timesteps", "64", "--restore_checkpoint_path", str(dirs[-1]),
          "--config_override", "num_evals=3")
    resumed = _saved(tmp_path / "resumed")
    assert [int(p.name.rsplit("_", 1)[1]) for p in resumed] == [32, 64]
    first, last = CKPT.restore(resumed[0]), CKPT.restore(resumed[-1])
    assert last["env_steps"] == 64 and all(float(s["step"]) == 4 for s in last["opt_state"]["state"].values())
    assert torch.equal(first["generator"], raw["generator"])  # the restored generator went on
    logged = [json.loads(line)["env_steps"] for line in (tmp_path / "resumed" / "metrics.jsonl").open()]
    assert logged == [32, 64]  # one JSON line per eval, the CLI's own log


def test_main_trains_randomized_and_evaluates_nominal(tmp_path, monkeypatch):
    from test_torch_ppo import ModelRecorder

    built = []

    def build(*args, **kwargs):
        built.append(ModelRecorder(runner_build_env(*args, **kwargs)))
        return built[-1]

    runner_build_env = runner.build_env
    monkeypatch.setattr(runner, "build_env", build)
    _main(tmp_path / "run", "--num_timesteps", "32", "--config_override", "num_evals=2")
    train_env, eval_env = built
    assert len(train_env.models) == 1 + 4 and all(m is train_env.models[0] for m in train_env.models)
    m = train_env.models[0]
    assert m is not train_env.model and m.body_mass.shape == (8,) + tuple(train_env.model.body_mass.shape)
    assert eval_env.models and all(x is eval_env.model for x in eval_env.models)


def test_unported_task_and_unknown_env_raise():
    """Every task of the CLI builds (the no-head robot has 10 actions); an
    unknown env raises."""
    env = runner.build_env("joystick", "flat_terrain_no_head", {"rsi_prob": 0.5}, device="cpu")
    assert env.action_size == 10 and env.config.rsi_prob == 0.5
    with pytest.raises(ValueError):
        runner.build_env("walking", "flat_terrain", device="cpu")
