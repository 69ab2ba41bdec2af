"""BENCHMARK.json: the committed file keeps the contract's shape, and the
parser refuses names, units and entries outside it."""

import copy
import json

import pytest

from benchmark.harness import manifest


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_committed_manifest_parses(man):
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert "eval.joystick_flat_backlash" in {w["name"] for w in man["workloads"]}
    everything = manifest.load(parked=True)
    names = {w["name"] for w in everything["workloads"]}
    assert {"train.joystick_flat_backlash", "train.standing_flat", "eval.joystick_flat_backlash"} <= names
    for w in everything["workloads"]:
        cell = manifest.cell(everything, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_file_is_found_by_name(man):
    everything = manifest.load(parked=True)
    for w in everything["workloads"]:
        cell = manifest.cell(everything, w["name"])
        assert manifest.config_of(manifest.BENCH_DIR, cell)["name"] == w["config"]
        traffic = manifest.read_json(manifest.BENCH_DIR, "traffic", w["traffic"])
        assert manifest.loop_class(manifest.BENCH_DIR, traffic["loop"]).kind == traffic["loop"]
        assert manifest.limits_of(manifest.BENCH_DIR, w["name"])
        for m in cell["per_layer"]:
            assert callable(manifest.metric_reader(manifest.BENCH_DIR, m["name"]))


@pytest.mark.parametrize("name, ok", [
    ("train.joystick_flat_backlash", True), ("_x-1.2", True), ("a" * 64, True), ("a" * 65, False),
    ("has space", False), ("comma,name", False), ("slash/name", False), ("-lead", False), (".lead", False),
    ("muµ", False), ("", False)])
def test_name_characters(name, ok):
    assert bool(manifest.NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit, ok", [
    ("env_steps/s", True), ("%", True), ("syncs/step", True), ("s", True), ("tokens per second", False),
    ("µs", False), ("a" * 17, False), ("", False)])
def test_unit_characters(unit, ok):
    assert bool(manifest.UNIT.fullmatch(unit)) is ok


def _broken(man, edit):
    m = copy.deepcopy(man)
    edit(m)
    return m


@pytest.mark.parametrize("what, edit", [
    ("extra top key", lambda m: m.update(extra=1)),
    ("extra metric key", lambda m: m["per_layer"][0].update(why="x")),
    ("run_seconds too long", lambda m: m.update(run_seconds=52)),
    ("bound too loose", lambda m: m["end_to_end"][0].update(bound=0.3)),
    ("bound too tight", lambda m: m["end_to_end"][1].update(bound=0.005)),
    ("no setup_s", lambda m: m["end_to_end"].pop(0)),
    ("duplicate cell", lambda m: m["workloads"].append(dict(m["workloads"][0]))),
    ("pair twice", lambda m: m["workloads"].append({**m["workloads"][0], "name": "other"})),
    ("chips 2", lambda m: m["workloads"][0].update(chips=2)),
    ("unknown config", lambda m: m["workloads"][0].update(config="nope")),
    ("moves nothing", lambda m: m["per_layer"][0].update(moves="nope")),
    ("bad source", lambda m: m["per_layer"][0].update(source="guess")),
    ("unit with space", lambda m: m["per_layer"][0].update(unit="per step")),
    ("why with newline", lambda m: m["workloads"][0].update(why="a\nb")),
    ("path outside", lambda m: m.update(paths=["../x"])),
    ("file outside paths", lambda m: m["configs"][0].update(file="other/x.json")),
    ("unused config", lambda m: m["configs"].append({**m["configs"][0], "name": "spare", "file": "benchmark/configs/spare.json"})),
    ("metric of no cell", lambda m: m["per_layer"][0].update(workloads=["nope"])),
])
def test_breaches_are_refused(man, what, edit):
    with pytest.raises(manifest.ManifestError):
        manifest.validate(_broken(man, edit))


def test_manifest_round_trips_through_json(man):
    assert manifest.validate(json.loads(json.dumps(man))) == man


def test_an_entry_of_the_manifest_takes_the_place_of_a_parked_one(man, tmp_path):
    """A change that brings a parked cell back adds its entries to
    BENCHMARK.json and edits no file: the parked entries of the same names
    give way, and every name stays unique."""
    (tmp_path / "benchmark").mkdir()
    parked = json.loads((manifest.BENCH_DIR / "parked.json").read_text())
    (tmp_path / "benchmark" / "parked.json").write_text(json.dumps(parked))
    back = copy.deepcopy(man)
    back["workloads"].append(next(w for w in parked["workloads"] if w["name"] == "train.joystick_flat_backlash"))
    rate = next(m for m in parked["end_to_end"] if m["name"] == "train_env_steps_per_s")
    back["end_to_end"].append({**rate, "workloads": ["train.joystick_flat_backlash"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(back))
    merged = manifest.load(tmp_path / "benchmark", parked=True)
    rates = [m for m in merged["end_to_end"] if m["name"] == "train_env_steps_per_s"]
    assert [m["workloads"] for m in rates] == [["train.joystick_flat_backlash"]]
    names = [w["name"] for w in merged["workloads"]]
    assert sorted(names) == sorted(set(names)) and "train.standing_flat" in names
    assert manifest.load(tmp_path / "benchmark") == manifest.validate(back)
