"""Training wrappers: episode truncation, action repeat, autoreset to the
cached reset state, per-env domain-randomized model, NaN quarantine, and the
evaluator's per-episode sums. Counterpart of
`open_duck_playground_tpu/envs/wrappers.py` (`TrainingEnv`, `EvalEnv`); the
env batch is the leading axis of every tensor instead of a vmap.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from open_duck_playground_torch.envs import step_graph
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
            info = dict(state.info)
            first_data = info.pop("first_data")
            first_obs = info.pop("first_obs")
            steps_prev = info.pop("steps")
            info.pop("truncation")

            # autoreset happens on the step after done was reported
            done_prev = state.done > 0
            data = _where_done(done_prev, first_data, state.data)
            obs = _where_done(done_prev, first_obs, state.obs)
            steps_prev = torch.where(done_prev, torch.zeros_like(steps_prev), steps_prev)
            state = state.replace(data=data, obs=obs, info=info)

            repeats = [draws] if self._action_repeat == 1 else draws
            if len(repeats) != self._action_repeat:
                raise ValueError(f"{len(repeats)} sets of step draws for action_repeat {self._action_repeat}")
            nstate = state
            for d in repeats:
                nstate = self._env.step(nstate, action, d, model=self._model)

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
            return nstate.replace(done=done, info=info)


class EvalEnv(TrainingEnv):
    """Adds the per-episode sums of the evaluator (brax EvalWrapper
    semantics): reward, length and every env metric accumulate until an
    env's first done, then freeze. They live in `info["eval_metrics"]`.

    On CUDA tensors under `torch.no_grad()` (`ppo.run_eval`), `step`
    replays a CUDA graph of its whole body, one per input signature, kept
    by this object (`envs/step_graph.py`); `_step` is the body, eager.
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

    def _step(self, state: State, action: torch.Tensor, draws) -> State:
        info = dict(state.info)
        em = info.pop("eval_metrics")
        nstate = super().step(state.replace(info=info), action, draws)
        alive = 1.0 - em["episode_done"]
        em = {
            "episode_reward": em["episode_reward"] + alive * nstate.reward,
            "episode_length": em["episode_length"] + alive,
            "episode_done": torch.maximum(em["episode_done"], nstate.done),
            "episode_metrics": {k: acc + alive * nstate.metrics[k]
                                for k, acc in em["episode_metrics"].items()},
        }
        ninfo = dict(nstate.info)
        ninfo["eval_metrics"] = em
        return nstate.replace(info=ninfo)
