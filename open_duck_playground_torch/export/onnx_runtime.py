"""Pure-numpy ONNX executor for exported policies. Counterpart of
`open_duck_playground_tpu/export/onnx_runtime.py`: it executes the small
op-set the exporter emits (onnxruntime is not a dependency)."""

from __future__ import annotations

import numpy as np

from open_duck_playground_torch.export import onnx_proto as OP


class OnnxPolicy:
    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            self.graph = OP.parse_model(f.read())
        self.input_name = self.graph["inputs"][0]
        self.output_name = self.graph["outputs"][0]

    def infer(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        vals = dict(self.graph["initializers"])
        vals[self.input_name] = obs
        for n in self.graph["nodes"]:
            op = n["op"]
            i = [vals[name] for name in n["inputs"]]
            if op == "Sub":
                out = [i[0] - i[1]]
            elif op == "Div":
                out = [i[0] / i[1]]
            elif op == "Add":
                out = [i[0] + i[1]]
            elif op == "Mul":
                out = [i[0] * i[1]]
            elif op == "MatMul":
                out = [i[0] @ i[1]]
            elif op == "Sigmoid":
                out = [1.0 / (1.0 + np.exp(-i[0]))]
            elif op == "Tanh":
                out = [np.tanh(i[0])]
            elif op == "Split":
                axis = n["attrs"].get("axis", 0)
                split = n["attrs"].get("split")
                if split:
                    out = np.split(i[0], np.cumsum(split)[:-1], axis=axis)
                else:
                    out = np.split(i[0], len(n["outputs"]), axis=axis)
            else:
                raise NotImplementedError(op)
            for name, v in zip(n["outputs"], out):
                vals[name] = v
        result = vals[self.output_name]
        return result[0] if squeeze else result
