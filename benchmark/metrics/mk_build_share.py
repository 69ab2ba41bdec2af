"""Share of the physics kernel's launches that ran the build of the cell's
own model, in %: the launches of the built library whose `kernel_dims`
equal the frozen `_kernel_work.kernel_dims` of the cell's model (the port's
read-out `build_launches()`, `physics/megakernel.py`: each library's count,
one per eager launch and one per replay of a CUDA graph that captured one)
over `launches`, x 100, as the run's process holds them when the readers
run (set-up, the untraced stretch, the traced unit and the sync-count
step). None in a program without the read-out or with no launch counted
(the CPU's plain engine launches none)."""

from benchmark.metrics import _kernel_work


def read(obs):
    try:
        from open_duck_playground_torch.physics import megakernel
    except ImportError:
        return None
    total, builds = getattr(megakernel, "launches", None), getattr(megakernel, "build_launches", None)
    if not total or builds is None:
        return None
    own = tuple(sorted(_kernel_work.kernel_dims(obs["model"].spec).items()))
    return 100.0 * builds().get(own, 0) / total
