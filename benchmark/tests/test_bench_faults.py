"""A run with the port's timed path broken underneath comes out not
correct, once for each fault a cell can have: a step that returns its state
unchanged (the env step; in training also the optimizer's), half of the
batch left out (training: each SGD step's loss a mean over half of its
minibatch, or every other minibatch of an epoch skipped; eval: the policy
acting on half of the envs), an answer altered where it is produced (the
policy's actions moved by 1e-2), and, in the eval at its 128 envs, the env
step wrong on one block of 8 envs. The cells run on one chip, so there is
no exchange between chips to leave out. The run skips the look for a card
and uses the cell's committed limits."""

import pytest
import torch

from benchmark.tests import _tiny


def _port():
    from benchmark.harness import port

    return port.modules()


def env_step_unchanged(mp, P):
    from open_duck_playground_torch.envs import joystick

    mp.setattr(joystick.Joystick, "step", lambda self, state, action, draws, model=None: state)


def one_block_wrong(mp, P):
    """qvel of the last 8 envs moved by 1e-2 after each env step."""
    from open_duck_playground_torch.envs import joystick

    inner = joystick.Joystick.step

    def step(self, state, action, draws, model=None):
        out = inner(self, state, action, draws, model=model)
        qvel = out.data.qvel.clone()
        qvel[-8:] += 1e-2
        return out.replace(data=out.data.replace(qvel=qvel))

    mp.setattr(joystick.Joystick, "step", step)


def optimizer_unchanged(mp, P):
    def apply_gradients(ts, max_grad_norm):
        grads = [p.grad for p in ts.net.parameters() if p.grad is not None]
        return {"grad_norm": P.ppo.global_norm(grads), "params_norm": P.ppo.global_norm(list(ts.net.parameters()))}

    mp.setattr(P.ppo, "apply_gradients", apply_gradients)


def half_batch_loss(mp, P):
    inner = P.ppo.loss_fn

    def loss_fn(net, normalizer, data, final_obs, entropy_noise, cfg, *args, **kwargs):
        h = entropy_noise.shape[1] // 2
        half = {k: ({kk: vv[:, :h] for kk, vv in v.items()} if isinstance(v, dict) else v[:, :h])
                for k, v in data.items()}
        return inner(net, normalizer, half, {k: v[:h] for k, v in final_obs.items()}, entropy_noise[:, :h], cfg,
                     *args, **kwargs)

    mp.setattr(P.ppo, "loss_fn", loss_fn)


def skip_minibatches(mp, P):
    """Every other SGD step's update left out."""
    inner, calls = P.ppo.apply_gradients, [0]

    def apply_gradients(ts, max_grad_norm):
        calls[0] += 1
        if calls[0] % 2:
            return inner(ts, max_grad_norm)
        grads = [p.grad for p in ts.net.parameters() if p.grad is not None]
        return {"grad_norm": P.ppo.global_norm(grads), "params_norm": P.ppo.global_norm(list(ts.net.parameters()))}

    mp.setattr(P.ppo, "apply_gradients", apply_gradients)


def half_batch_actions(mp, P):
    from open_duck_playground_torch.train import networks

    def postprocess(raw):
        a = torch.tanh(raw)
        return torch.cat([a[: a.shape[0] // 2], torch.zeros_like(a[a.shape[0] // 2 :])])

    mp.setattr(networks, "postprocess", postprocess)


def answer_altered(mp, P):
    from open_duck_playground_torch.train import networks

    mp.setattr(networks, "postprocess", lambda raw: torch.tanh(raw) + 1e-2)


TRAIN = [env_step_unchanged, optimizer_unchanged, half_batch_loss, skip_minibatches, answer_altered]
EVAL = [env_step_unchanged, half_batch_actions, answer_altered]


@pytest.mark.parametrize("cell, fault", [(c, f) for c in ("train.joystick_flat_backlash", "train.standing_flat")
                                         for f in TRAIN] + [("eval.joystick_flat_backlash", f) for f in EVAL],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, _port())
    result = _tiny.run(cell)
    failed = [name for name, c in result["checks"].items() if not c["value"] <= c["limit"]]
    assert not result["correct"] and failed, result["checks"]


def test_one_block_of_envs_wrong_is_not_correct(monkeypatch):
    """The eval at its own 128 envs, the env step wrong on 8 of them: one
    block of the physics kernel, a twentieth of every checked row."""
    one_block_wrong(monkeypatch, _port())
    result = _tiny.run("eval.joystick_flat_backlash", ppo={**_tiny.EVAL_PPO, "num_eval_envs": 128})
    failed = [name for name, c in result["checks"].items() if not c["value"] <= c["limit"]]
    assert not result["correct"] and "qvel" in failed, result["checks"]
