"""Operations of a whole training step and of an eval control step, as
`step_mfu` counts them: the physics kernel's launches (`_kernel_work`, at
the cell's envs, substeps and the window's active rows) and the MLPs'
products, two operations per multiply-add. Recomputation is not counted,
and nor is the elementwise work around the products (activations, GAE, the
PPO terms, Adam), so the count is a floor of the work done."""

from __future__ import annotations

from typing import Sequence

from benchmark.metrics import _kernel_work


def mlp_forward(sizes: Sequence[int]) -> int:
    """Operations of one sample through the MLP of layer widths `sizes`."""
    return sum(2 * i * o for i, o in zip(sizes[:-1], sizes[1:]))


def mlp_backward(sizes: Sequence[int]) -> int:
    """The weight gradients of every layer and the input gradients of all
    but the first: twice the forward's products, less the first layer's
    input gradient."""
    return 2 * mlp_forward(sizes) - 2 * sizes[0] * sizes[1]


def kernel_ops(model, shape: dict, active: dict) -> float:
    return _kernel_work.megakernel_work(model, shape["envs"], shape["substeps"], active["contacts"],
                                        active["limits"])[1]


def train_step_ops(model, shape: dict, active: dict) -> float:
    """One PPO training step: its kernel launches, the policy's forward pass
    on every rollout sample, both MLPs forward and backward over every epoch
    of the batch, and the value net on each minibatch's final observations."""
    policy, value = shape["policy_sizes"], shape["value_sizes"]
    samples, epochs = shape["samples"], shape["epochs"]
    sgd_steps = epochs * shape["minibatches"]
    return (shape["launches"] * kernel_ops(model, shape, active)
            + samples * mlp_forward(policy)
            + epochs * samples * (mlp_forward(policy) + mlp_backward(policy)
                                  + mlp_forward(value) + mlp_backward(value))
            + sgd_steps * shape["batch"] * mlp_forward(value))


def eval_steps_ops(model, shape: dict, active: dict) -> float:
    """`launches` eval control steps: one kernel launch and the policy's
    forward pass on every env each."""
    return shape["launches"] * kernel_ops(model, shape, active) + shape["samples"] * mlp_forward(shape["policy_sizes"])
