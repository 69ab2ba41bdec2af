"""Share of the training wrapper's steps on the card that ran as its two
CUDA kernels, in %: the port's counters `launches` (fused wrapper steps:
one per eager launch of the kernel after the task's step, and one per
replay of a CUDA graph that captured one) over `launches` + `eager_steps`
(wrapper bodies on CUDA tensors that ran eagerly, counted the same way),
x 100 (`envs/wrapper_kernel.py`), as the run's process holds them when the
readers run (set-up, the untraced stretch, the traced unit and the
sync-count step). None in a program without the counters or with neither
counted."""


def read(obs):
    try:
        from open_duck_playground_torch.envs import wrapper_kernel
    except ImportError:
        return None
    fused, eager = getattr(wrapper_kernel, "launches", None), getattr(wrapper_kernel, "eager_steps", None)
    if fused is None or eager is None or not fused + eager:
        return None
    return 100.0 * fused / (fused + eager)
