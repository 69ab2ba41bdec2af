"""Share of the physics kernel's launches that ran its heightfield build,
in %: the port's counters `launches_hfield` over `launches`
(`physics/megakernel.py`: one per eager launch and one per replay of a
CUDA graph that captured one), x 100, as the run's process holds them when
the readers run (set-up, the untraced stretch, the traced unit and the
sync-count step). None in a program without the counters or with no
launch counted (the CPU's plain engine launches none)."""


def read(obs):
    try:
        from open_duck_playground_torch.physics import megakernel
    except ImportError:
        return None
    total, hfield = getattr(megakernel, "launches", None), getattr(megakernel, "launches_hfield", None)
    if not total or hfield is None:
        return None
    return 100.0 * hfield / total
