"""ctypes binding to the native C++ ONNX policy runtime
(`csrc/duck_onnx/onnx_mlp.cc`), the robot's inference path. Counterpart of
`open_duck_playground_tpu/export/native_runtime.py`.

The library is built at first use with the host's C++ compiler into
`build/host/` (`cuda_build.build(..., host=True)`); a failed build raises.
Interface-compatible with `OnnxPolicy.infer` for one observation.
"""

from __future__ import annotations

import ctypes

import numpy as np

from open_duck_playground_torch import cuda_build
from open_duck_playground_torch.export.onnx_runtime import OnnxPolicy

SOURCE = "duck_onnx/onnx_mlp.cc"
_F32P = ctypes.POINTER(ctypes.c_float)


def load_library() -> ctypes.CDLL:
    lib = cuda_build.build(SOURCE, host=True).lib
    lib.duck_onnx_load.restype = ctypes.c_void_p
    lib.duck_onnx_load.argtypes = [ctypes.c_char_p]
    lib.duck_onnx_infer.restype = ctypes.c_int
    lib.duck_onnx_infer.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int, _F32P, ctypes.c_int]
    lib.duck_onnx_free.restype = None
    lib.duck_onnx_free.argtypes = [ctypes.c_void_p]
    return lib


def action_size(model_path: str) -> int:
    """Half the width of the last layer's kernel (loc and log-scale)."""
    inits = OnnxPolicy(model_path).graph["initializers"]
    last = max((k for k in inits if k.startswith("w_")), key=lambda k: int(k.split("_")[1]))
    return inits[last].shape[1] // 2


class NativeOnnxPolicy:
    def __init__(self, model_path: str, act_size: int | None = None):
        self._lib = load_library()
        self._h = self._lib.duck_onnx_load(str(model_path).encode())
        if not self._h:
            raise RuntimeError(f"failed to load {model_path}")
        self._act_size = action_size(model_path) if act_size is None else act_size

    def infer(self, obs: np.ndarray) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32).ravel()
        out = np.empty(self._act_size, np.float32)
        rc = self._lib.duck_onnx_infer(self._h, obs.ctypes.data_as(_F32P), obs.size,
                                       out.ctypes.data_as(_F32P), out.size)
        if rc != 0:
            raise RuntimeError(f"duck_onnx_infer failed: {rc}")
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.duck_onnx_free(self._h)
            self._h = None
