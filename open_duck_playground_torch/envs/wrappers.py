"""Training wrappers: episode truncation, action repeat, autoreset to the
cached reset state, per-env domain-randomized model, NaN quarantine, and the
evaluator's per-episode sums. Counterpart of
`open_duck_playground_tpu/envs/wrappers.py` (`TrainingEnv`, `EvalEnv`); the
env batch is the leading axis of every tensor instead of a vmap. On CUDA
tensors the step's bookkeeping runs as two CUDA kernels around the task's
step (`envs/wrapper_kernel.py`); `TrainingEnv.eager_step` is its plain
version.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from open_duck_playground_torch.envs import step_graph, wrapper_kernel
from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.envs.randomize import DRDraws
from open_duck_playground_torch.physics.types import Data
from open_duck_playground_torch.utils import tracing


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _where_done(done: torch.Tensor, x, y):
    """Per env: x where done else y (Data or dict of tensors)."""
    sel = lambda a, b: torch.where(_bcast(done, a), a, b)
    if isinstance(x, Data):
        return Data(**{k: sel(v, getattr(y, k)) for k, v in x.fields()})
    return {k: sel(v, y[k]) for k, v in x.items()}


def _sanitize(bad: torch.Tensor, tree):
    """nan_to_num the float tensors of the `bad` envs (Data or dict)."""

    def fix(a):
        if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
            return a
        return torch.where(_bcast(bad, a), torch.nan_to_num(a), a)

    if isinstance(tree, Data):
        return tree.map(fix)
    return {k: fix(v) for k, v in tree.items()}


def env_finite(state: State) -> torch.Tensor:
    """(B,) bool: True where obs, qpos and qvel are all finite."""
    leaves = list(state.obs.values()) + [state.data.qpos, state.data.qvel]
    flags = [torch.isfinite(x).reshape(x.shape[0], -1).all(1) for x in leaves]
    return torch.stack(flags, 0).all(0)


class TrainingEnv:
    """reset(draws) -> batched State; step(state, action, draws) -> State.

    With `randomization_fn` and its `dr_draws` (both or neither; the port's
    is `envs.randomize.domain_randomize`) the env runs on
    `randomization_fn(env.model, dr_draws)`, a model whose randomized fields
    carry one value per env; without them on the nominal model. With `action_repeat` n > 1 one step runs the env n
    times on the same action, and `draws` is a sequence of n sets of step
    draws (`step_draws` makes them); the reward is the last repeat's, as in
    the reference."""

    def __init__(self, env, episode_length: int, dr_draws: Optional[DRDraws] = None,
                 action_repeat: int = 1, randomization_fn: Optional[Callable] = None):
        self._env = env
        self._episode_length = episode_length
        self._action_repeat = action_repeat
        if (randomization_fn is None) != (dr_draws is None):
            raise ValueError("randomization_fn and dr_draws go together")
        self._model = env.model if dr_draws is None else randomization_fn(env.model, dr_draws)

    @property
    def env(self):
        return self._env

    @property
    def action_size(self) -> int:
        return self._env.action_size

    def step_draws(self, gen: torch.Generator, batch: int):
        """The env's step draws, or a list of `action_repeat` of them."""
        if self._action_repeat == 1:
            return self._env.step_draws(gen, batch)
        return [self._env.step_draws(gen, batch) for _ in range(self._action_repeat)]

    def reset(self, draws) -> State:
        with tracing.span("env.reset"):
            state = self._env.reset(draws, model=self._model)
            # finite floor: a pathological randomized model must not cache NaN
            # as the autoreset target
            bad = ~env_finite(state)
            state = state.replace(data=_sanitize(bad, state.data), obs=_sanitize(bad, state.obs))
            B = state.reward.shape[0]
            info = dict(state.info)
            info["steps"] = torch.zeros(B, dtype=torch.float32, device=state.reward.device)
            info["truncation"] = torch.zeros_like(info["steps"])
            info["first_data"] = state.data
            info["first_obs"] = state.obs
            return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor, draws) -> State:
        with tracing.span("env.wrapper"):
            return self._step(state, action, draws)

    def _step(self, state: State, action: torch.Tensor, draws) -> State:
        """The wrapper's step: on CUDA tensors its bookkeeping runs as two
        kernels around the task's steps (`envs/wrapper_kernel.py`), on CPU
        tensors as `eager_step`."""
        if state.done.is_cuda:
            return wrapper_kernel.step(self.task_steps, state, action, draws, self._action_repeat,
                                       self._episode_length)
        return self.eager_step(state, action, draws)

    def task_steps(self, state: State, action: torch.Tensor, draws) -> State:
        """The task's step, `action_repeat` times on the same action."""
        repeats = [draws] if self._action_repeat == 1 else draws
        if len(repeats) != self._action_repeat:
            raise ValueError(f"{len(repeats)} sets of step draws for action_repeat {self._action_repeat}")
        for d in repeats:
            state = self._env.step(state, action, d, model=self._model)
        return state

    def eager_step(self, state: State, action: torch.Tensor, draws) -> State:
        """The wrapper's step in PyTorch operations: the CPU's path and the
        reference of the fused step. Where the state carries the evaluator's
        sums (`EvalEnv`'s `info["eval_metrics"]`), it takes them too."""
        if state.done.is_cuda:
            wrapper_kernel.count_eager_step()
        info = dict(state.info)
        em = info.pop("eval_metrics", None)
        first_data = info.pop("first_data")
        first_obs = info.pop("first_obs")
        steps_prev = info.pop("steps")
        info.pop("truncation")

        # autoreset happens on the step after done was reported
        done_prev = state.done > 0
        data = _where_done(done_prev, first_data, state.data)
        obs = _where_done(done_prev, first_obs, state.obs)
        steps_prev = torch.where(done_prev, torch.zeros_like(steps_prev), steps_prev)
        nstate = self.task_steps(state.replace(data=data, obs=obs, info=info), action, draws)

        # quarantine non-finite envs: cached reset state, zero reward, done
        bad = ~env_finite(nstate)
        nstate = nstate.replace(
            data=_where_done(bad, first_data, nstate.data),
            obs=_where_done(bad, first_obs, nstate.obs),
            reward=torch.where(bad, torch.zeros_like(nstate.reward), nstate.reward),
            done=torch.where(bad, torch.ones_like(nstate.done), nstate.done),
            info=_sanitize(bad, nstate.info),
            metrics=_sanitize(bad, nstate.metrics),
        )

        steps = steps_prev + self._action_repeat
        at_limit = steps >= self._episode_length
        done = torch.where(at_limit, torch.ones_like(nstate.done), nstate.done)
        truncation = at_limit * (1 - nstate.done)

        info = dict(nstate.info)
        info["steps"] = steps
        info["truncation"] = truncation
        info["first_data"] = first_data
        info["first_obs"] = first_obs
        nstate = nstate.replace(done=done, info=info)
        return nstate if em is None else _episode_sums(nstate, em)


def _episode_sums(state: State, em) -> State:
    """The evaluator's per-episode sums after `state`'s step, in its info."""
    alive = 1.0 - em["episode_done"]
    em = {
        "episode_reward": em["episode_reward"] + alive * state.reward,
        "episode_length": em["episode_length"] + alive,
        "episode_done": torch.maximum(em["episode_done"], state.done),
        "episode_metrics": {k: acc + alive * state.metrics[k] for k, acc in em["episode_metrics"].items()},
    }
    info = dict(state.info)
    info["eval_metrics"] = em
    return state.replace(info=info)


class EvalEnv(TrainingEnv):
    """Adds the per-episode sums of the evaluator (brax EvalWrapper
    semantics): reward, length and every env metric accumulate until an
    env's first done, then freeze. They live in `info["eval_metrics"]`.

    The sums are the body's own (`TrainingEnv._step` takes them where the
    state carries them, as this env's reset makes it). On CUDA tensors
    under `torch.no_grad()` (`ppo.run_eval`), `step` replays a CUDA graph
    of that body, one per input signature, kept by this object
    (`envs/step_graph.py`); `_step` runs the body without the graph.
    `act_graphs` keeps the graphs of `ppo.run_eval`'s draws and policy
    in front of each step (`ppo.eval_actor`): their key holds this env.
    Both capture on the same side stream."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._graphs = step_graph.StepGraphs()
        self.act_graphs = step_graph.StepGraphs("act.graph", streams=self._graphs.streams)

    def reset(self, draws) -> State:
        with tracing.span("env.reset"):
            state = super().reset(draws)
            z = lambda: torch.zeros_like(state.reward)
            info = dict(state.info)
            info["eval_metrics"] = {
                "episode_reward": z(),
                "episode_length": z(),
                "episode_done": z(),
                "episode_metrics": {k: z() for k in state.metrics},
            }
            return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor, draws) -> State:
        with tracing.span("env.wrapper"):
            return self._graphs(self._step, (state, action, draws), self._model)
