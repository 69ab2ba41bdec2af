"""A policy trained by the port on the card, as a regression test on the CPU.

`fixtures/torch_parity_joystick.onnx` is the final policy of the port's
full-length run of the reference's "current win" recipe on an NVIDIA H100
(joystick on flat_terrain_backlash, 302,776,320 env steps, seed 0,
`num_evals=15`; PERF.md, "Training outcome on the card"). It must pass the
port's validator and, in stock C-MuJoCo, the two rows of the transfer
matrix that every JAX seed passes at that budget (RESULTS.md:172-197):
stand for 10 s without falling, and walk forward at 0.14 m/s for 10 s
without falling and past x = 0.5 m.
"""

import hashlib
import pathlib

import pytest

from open_duck_playground_torch.envs import duck_base
from open_duck_playground_torch.export.onnx_validate import validate_file
from open_duck_playground_torch.tools import transfer_matrix as TM

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_parity_joystick.onnx"
SHA256 = "1da0d6eb1c6c373983903b8ba209967ddd54e3f47c9b083002b44444ffc379f4"
SCENE = duck_base.XML_DIR / "scene_flat_terrain_backlash.xml"
SECONDS = 10.0


def test_fixture_is_the_card_trained_policy():
    assert hashlib.sha256(FIXTURE.read_bytes()).hexdigest() == SHA256


def test_trained_policy_validates():
    summary = validate_file(str(FIXTURE))
    assert summary["outputs"] == {"continuous_actions": (1, 14)}


@pytest.mark.parametrize("row", ["stand", "forward 0.14 m/s"])
def test_trained_policy_transfers(row):
    from open_duck_playground_torch.eval_tools.mujoco_runner import ClosedLoopRunner

    _, command, criterion = next(r for r in TM.ROWS if r[0] == row)
    stats = ClosedLoopRunner(str(SCENE), str(FIXTURE)).run_headless(SECONDS, commands=command)
    assert not stats["fell"], stats
    assert TM._passes(stats, criterion), stats
    if criterion is not None:
        assert stats["final_xy"][0] > 0.5, stats
