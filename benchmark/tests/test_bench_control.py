"""The control comes out not correct: the reference computed in TF32
(float32 products through the tensor cores, the precision below the
configurations' true f32) put in the port's place, judged against the
reference with each cell's committed limits. Card-only (TF32 exists only
there), at a size a test run holds; `benchmark/calibrate.py` reads the same
at each cell's own size."""

import gc

import pytest
import torch

from benchmark.harness import check, runner

TRAIN_PPO = dict(num_envs=512, batch_size=64, num_minibatches=8, unroll_length=10, num_updates_per_batch=2)
TRAIN_TRAFFIC = dict(setup_steps=2, checked_steps=2, checked_envs=256, reference_block_steps=5)
EVAL_PPO = dict(num_eval_envs=128, episode_length=40)
EVAL_TRAFFIC = dict(warmup_steps=2, checked_steps_per_eval=6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 products exist only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["train.joystick_flat_backlash", "train.standing_flat"])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7, 3_000_000_019])
def test_training_control_is_not_correct(card, cell, seed):
    _, config, traffic, limits = runner.prepare(cell, config_overrides=TRAIN_PPO, traffic_overrides=TRAIN_TRAFFIC)
    loop = runner.make_loop(config, traffic, seed, card)
    loop.setup()
    loop.free()
    gc.collect()
    rec = loop.record
    ref = check.train_reference(rec, config, traffic, card)
    sound = check.verdict(check.train_numbers(check.program_outputs(rec), ref, rec, traffic), limits)
    control = check.verdict(check.train_numbers(check.train_reference(rec, config, traffic, card, "tf32"), ref, rec,
                                                traffic), limits)
    assert all(c["ok"] for c in sound.values()), sound
    assert not all(c["ok"] for c in control.values()), control


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [102, 2 ** 31 + 8, 3_000_000_021])
def test_eval_control_is_not_correct(card, seed):
    _, config, traffic, limits = runner.prepare("eval.joystick_flat_backlash", config_overrides=EVAL_PPO,
                                                traffic_overrides=EVAL_TRAFFIC)
    loop = runner.make_loop(config, traffic, seed, card)
    loop.setup()
    loop.window(0.0)
    judge = lambda prec, per_step=False: check.eval_reference(loop.records, config, loop.params0, loop.normalizer0,
                                                              loop.deterministic, card, prec, per_step)
    ref = judge("f32")
    sound = check.verdict(check.eval_numbers(check.eval_program_outputs(loop.records), ref, loop.records, traffic),
                          limits)
    control = check.verdict(check.eval_numbers(judge("tf32", per_step=True), ref, loop.records, traffic), limits)
    assert not control["qvel"]["ok"], control
    assert all(c["ok"] for c in sound.values()), sound
    assert not all(c["ok"] for c in control.values()), control
