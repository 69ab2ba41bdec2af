"""The benchmark's plain reference: a frozen copy of the port's plain engine
(`physics/`, the loop of plain substeps; no CUDA kernel), its task code
(`envs/`: joystick, standing, rewards, gait oracle, domain randomization,
training wrappers), the model snapshots it reads (`models/data/`), and PPO's
policy, loss, GAE, normalizer and Adam (`train/`), rewritten so that nothing
here imports the port (`open_duck_playground_torch`) or JAX.

Later changes to the port do not move it: it is the yardstick the
benchmark's `correct` holds the port's timed path against, step by step
from the port's own states. Nothing here sets the float32 matmul precision;
the caller does (true f32 for the reference, TF32 for its control).
"""
