"""Policy -> ONNX export (opset 11), no `onnx`/`tf2onnx` dependency.
Counterpart of `open_duck_playground_tpu/export/onnx_export.py`: the same
graph, byte for byte, from the port's network.

Output contract of the deployment artifact: input "obs" shaped
(1, obs_size), output "continuous_actions" = tanh(loc of split logits), the
running normalizer's mean/std baked in as Sub/Div nodes, swish hidden
activations emitted as Sigmoid + Mul.
"""

from __future__ import annotations

import numpy as np
import torch

from open_duck_playground_torch.export import onnx_proto as OP


def build_policy_onnx(
    mean: np.ndarray,
    std: np.ndarray,
    layers,  # list of (kernel (in, out), bias (out,)) from first to last
    obs_size: int,
    act_size: int,
) -> bytes:
    nodes = []
    inits = [
        OP.tensor("obs_mean", mean.reshape(1, -1)),
        OP.tensor("obs_std", std.reshape(1, -1)),
    ]
    nodes.append(OP.node("Sub", ["obs", "obs_mean"], ["obs_centered"]))
    nodes.append(OP.node("Div", ["obs_centered", "obs_std"], ["obs_norm"]))

    x = "obs_norm"
    n = len(layers)
    for i, (kernel, bias) in enumerate(layers):
        inits.append(OP.tensor(f"w_{i}", kernel))
        inits.append(OP.tensor(f"b_{i}", bias.reshape(1, -1)))
        nodes.append(OP.node("MatMul", [x, f"w_{i}"], [f"mm_{i}"]))
        nodes.append(OP.node("Add", [f"mm_{i}", f"b_{i}"], [f"dense_{i}"]))
        x = f"dense_{i}"
        if i < n - 1:  # swish
            nodes.append(OP.node("Sigmoid", [x], [f"sig_{i}"]))
            nodes.append(OP.node("Mul", [x, f"sig_{i}"], [f"swish_{i}"]))
            x = f"swish_{i}"

    nodes.append(
        OP.node(
            "Split",
            [x],
            ["loc", "log_scale"],
            attrs_int={"axis": 1},
            attrs_ints={"split": [act_size, act_size]},
        )
    )
    nodes.append(OP.node("Tanh", ["loc"], ["continuous_actions"]))

    g = OP.graph(
        nodes,
        "duck_policy",
        inits,
        inputs=[OP.value_info("obs", (1, obs_size))],
        outputs=[OP.value_info("continuous_actions", (1, act_size))],
    )
    return OP.model(g, opset=11)


def export_policy(variables, act_size, ppo_params, obs_size, output_path):
    """variables = (normalizer, net) as `train.ppo` and the checkpoints give
    them: `normalizer.mean["state"]` / `.std["state"]` and the layers of
    `net.policy`, each `nn.Linear.weight` (out, in) written as the (in, out)
    kernel. `ppo_params` is unused, as in the JAX exporter."""
    del ppo_params
    normalizer, net = variables
    host = lambda t: t.detach().to("cpu", torch.float32).numpy()
    mean = host(normalizer.mean["state"])
    std = host(normalizer.std["state"])
    layers = [(host(layer.weight).T, host(layer.bias)) for layer in net.policy.layers]
    assert layers[-1][1].shape[0] == 2 * act_size, (layers[-1][1].shape, act_size)
    blob = build_policy_onnx(mean, std, layers, obs_size, act_size)
    with open(output_path, "wb") as f:
        f.write(blob)
    print(f"Exported ONNX policy: {output_path} ({len(blob)} bytes)")
    return output_path
