"""The reference against the port's plain path at a tiny size: on the
CPU the port's physics is its plain engine, of which the reference holds a
frozen copy, so every number the check compares is at rounding, and a run
of each cell comes out correct."""

import pytest
import torch

from benchmark.harness import inputs, trees
from benchmark.tests import _tiny

CELLS = ("train.joystick_flat_backlash", "train.standing_flat", "eval.joystick_flat_backlash")


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(cell):
    result = _tiny.run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] <= 1e-5, (name, c)


@pytest.mark.parametrize("config", [{"env": "joystick", "env_class": "Joystick", "task": "flat_terrain_backlash"},
                                    {"env": "standing", "env_class": "Standing", "task": "flat_terrain"}])
def test_reference_env_steps_as_the_port(config):
    """One reset and two control steps of the port's and the reference's
    training env from the same draws, per-env randomized models."""
    from benchmark.harness import port
    from benchmark.reference.envs import randomize as RR

    torch.set_num_threads(2)
    P = port.modules()
    gen = inputs.generator(7, "cpu")
    ref_env = inputs.reference_env(config, "cpu")
    env = port.env(P, config, "cpu")
    classes = port.classes()
    dr = RR.DRDraws.sample(gen, 6, ref_env.model.spec)
    ref_tenv = inputs.reference_training_env(ref_env, {"ppo": {"episode_length": 1000, "action_repeat": 1}}, dr)
    tenv = P.wrappers.TrainingEnv(env, 1000, dr_draws=trees.recast(dr, classes),
                                  randomization_fn=P.randomize.domain_randomize)
    reset = ref_env.reset_draws(gen, 6)
    a, b = tenv.reset(trees.recast(reset, classes)), ref_tenv.reset(reset)
    for _ in range(2):
        action = torch.tanh(torch.randn((6, env.action_size), generator=gen))
        draws = ref_env.step_draws(gen, 6)
        a, b = tenv.step(a, action, trees.recast(draws, classes)), ref_tenv.step(b, action, draws)
        for k in b.obs:
            torch.testing.assert_close(a.obs[k], b.obs[k], rtol=0, atol=0)
        torch.testing.assert_close(a.data.qvel, b.data.qvel, rtol=0, atol=0)
        torch.testing.assert_close(a.reward, b.reward, rtol=0, atol=0)
