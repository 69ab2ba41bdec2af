"""The benchmark's frozen operation and byte count of a megakernel launch
equals the port's `tools/count_kernel_ops.megakernel_work` today, on the
four scenes `tools/bench_physics.py` runs, in both partitions."""

from dataclasses import astuple

import pytest
import torch

from benchmark.metrics import _kernel_work, _step_work

SCENES = ("scene_flat_terrain_backlash", "scene_flat_terrain", "scene_rough_terrain_backlash",
          "scene_flat_terrain_no_head")


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("dense", [False, True])
def test_frozen_count_equals_the_ports(scene, dense):
    from open_duck_playground_torch.models import loader
    from open_duck_playground_torch.tools import count_kernel_ops

    m = loader.load_model(scene, device="cpu", dtype=torch.float32, timestep=0.002)
    for envs, contacts, limits in ((8192, 7.41, 5.49), (128, 0.0, 0.0), (4096, 8.0, 12.0)):
        assert _kernel_work.megakernel_work(m, envs, 10, contacts, limits, dense) == \
            count_kernel_ops.megakernel_work(m, envs, 10, contacts, limits, dense)


def test_partition_equals_the_ports():
    from open_duck_playground_torch.models import loader
    from open_duck_playground_torch.physics import megakernel

    for scene in SCENES:
        spec = loader.load_model(scene, device="cpu").spec
        for dense in (False, True):
            assert astuple(_kernel_work.partition(spec, dense)) == astuple(megakernel.partition(spec, dense))
            assert _kernel_work.kernel_dims(spec, dense) == megakernel.kernel_dims(spec, dense)


def test_active_rows_of_the_home_pose():
    from benchmark.reference.models import loader

    m = loader.load_model("scene_flat_terrain_backlash", device="cpu")
    qpos = m.key_qpos[None].repeat(3, 1)
    data = type("D", (), {"qpos": qpos, "contact_dist": torch.tensor([[-1e-3, 0.0, 2e-3, -5e-4]] * 3)})
    contacts, limits = _kernel_work.active_rows(m, data)
    assert contacts == 2.0 and limits >= 0.0


def test_mlp_operations():
    assert _step_work.mlp_forward([3, 4, 2]) == 2 * (12 + 8)
    assert _step_work.mlp_backward([3, 4, 2]) == 2 * 2 * (12 + 8) - 2 * 12
