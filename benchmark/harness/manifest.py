"""`BENCHMARK.json` and the files the harness finds by name.

A cell of `workloads` names a configuration and a traffic mix. Each lives
in a file of its own under the benchmark's folder, found by its name:

    configs/<config>.json    the configuration as it is run
    traffic/<traffic>.json   the mix's parameters, read by the loop it names
    harness/loops/<loop>.py  the general loop that runs one kind of mix (`Loop`)
    metrics/<metric>.py      the reader of one per-layer metric (`read(obs)`);
                             a metric `<quantity>.<kind>` that has no file of
                             its own is read by `metrics/<quantity>.py`
    limits/<cell>.json       the limits `correct` holds the cell's numbers to
    parked.json              the entries of cells taken out of BENCHMARK.json
                             whose files stay (run, calibrated and tested
                             still; not measured by the check)

so a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none that is there.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class ManifestError(ValueError):
    pass


def _line(text, what: str) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line, got {text!r}")


def _name(text, what: str) -> None:
    if not isinstance(text, str) or not NAME.fullmatch(text):
        raise ManifestError(f"{what}: not a name (letters, digits, _ . -; at most 64): {text!r}")


def _keys(entry: dict, required: set, what: str, optional: set = frozenset()) -> None:
    keys = set(entry)
    if not required <= keys or not keys <= required | optional:
        raise ManifestError(f"{what}: keys {sorted(keys)}, want {sorted(required)}"
                            + (f" and optionally {sorted(optional)}" if optional else ""))


def validate(man: dict) -> dict:
    """`man` if it keeps the contract's shape and characters; raises
    ManifestError at the first breach."""
    if set(man) != TOP_KEYS:
        raise ManifestError(f"top-level keys {sorted(man)}, want {sorted(TOP_KEYS)}")
    cmd = man["command"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        raise ManifestError("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "command word")
    paths = man["paths"]
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise ManifestError("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.fullmatch(p) or p.startswith("/") or ".." in p.split("/"):
            raise ManifestError(f"paths: not a relative path inside the repository: {p!r}")
    rs = man["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        raise ManifestError("run_seconds: a whole number from 1 to 51")

    names = set()

    def unique(name, what):
        _name(name, what)
        if name in names:
            raise ManifestError(f"{what}: the name {name!r} is used twice")
        names.add(name)

    configs = man["configs"]
    if not isinstance(configs, list) or not 1 <= len(configs) <= 24:
        raise ManifestError("configs: 1 to 24 entries")
    for c in configs:
        _keys(c, CONFIG_KEYS, f"config {c.get('name')!r}")
        unique(c["name"], "config name")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise ManifestError("reduced: a list of at most 16 keys")
        for key in c["reduced"]:
            _name(key, "reduced key")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            raise ManifestError(f"config file {c['file']!r} lies under no path")
    if len({c["file"] for c in configs}) != len(configs):
        raise ManifestError("two configurations share a file")

    cells = man["workloads"]
    if not isinstance(cells, list) or not 1 <= len(cells) <= 24:
        raise ManifestError("workloads: 1 to 24 cells")
    config_names = {c["name"] for c in configs}
    pairs = set()
    for w in cells:
        _keys(w, CELL_KEYS, f"cell {w.get('name')!r}")
        unique(w["name"], "cell name")
        _name(w["config"], "cell config")
        _name(w["traffic"], "cell traffic")
        _line(w["why"], "cell why")
        if w["config"] not in config_names:
            raise ManifestError(f"cell {w['name']!r}: no configuration {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"cell {w['name']!r}: chips must be 1 or 4")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            raise ManifestError(f"cell {w['name']!r}: configuration and traffic already paired")
        pairs.add(pair)
    unused = config_names - {w["config"] for w in cells}
    if unused:
        raise ManifestError(f"configurations no cell uses: {sorted(unused)}")

    cell_names = {w["name"] for w in cells}
    e2e = man["end_to_end"]
    if not isinstance(e2e, list) or not 1 <= len(e2e) <= 16:
        raise ManifestError("end_to_end: 1 to 16 metrics")
    if "setup_s" not in {m.get("name") for m in e2e}:
        raise ManifestError("end_to_end: setup_s is required")
    layers = man["per_layer"]
    if not isinstance(layers, list) or not 1 <= len(layers) <= 128:
        raise ManifestError("per_layer: 1 to 128 metrics")
    for group, keys, allowed in ((e2e, E2E_KEYS, ("host_clock", "device_trace")), (layers, LAYER_KEYS, SOURCES)):
        for m in group:
            _keys(m, keys, f"metric {m.get('name')!r}", {"workloads"})
            unique(m["name"], "metric name")
            if not isinstance(m["unit"], str) or not UNIT.fullmatch(m["unit"]):
                raise ManifestError(f"metric {m['name']!r}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                raise ManifestError(f"metric {m['name']!r}: better is lower or higher")
            if m["source"] not in allowed:
                raise ManifestError(f"metric {m['name']!r}: source {m['source']!r} not in {allowed}")
            for w in m.get("workloads", []):
                if w not in cell_names:
                    raise ManifestError(f"metric {m['name']!r}: no cell {w!r}")
    for m in e2e:
        b = m["bound"]
        if not isinstance(b, (int, float)) or isinstance(b, bool) or not 0.01 <= b <= 0.25:
            raise ManifestError(f"metric {m['name']!r}: bound from 0.01 to 0.25")
    e2e_names = {m["name"] for m in e2e}
    for m in layers:
        _line(m["layer"], "layer")
        if m["moves"] not in e2e_names:
            raise ManifestError(f"metric {m['name']!r} moves no end-to-end metric {m['moves']!r}")
    return man


def load(bench_dir: pathlib.Path = BENCH_DIR, parked: bool = False) -> dict:
    """The validated manifest beside `bench_dir` (the repository root's
    `BENCHMARK.json`); with `parked`, the entries of `<bench_dir>/parked.json`
    (cells taken out of it, whose files stay) added to its lists, where
    `BENCHMARK.json` has no entry of the same name."""
    path = pathlib.Path(bench_dir).parent / "BENCHMARK.json"
    man = validate(json.loads(path.read_text()))
    if not parked:
        return man
    extra = json.loads((pathlib.Path(bench_dir) / "parked.json").read_text())
    merged = dict(man)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"] for e in man[key]}
        merged[key] = man[key] + [e for e in extra.get(key, []) if e["name"] not in have]
    return validate(merged)


def _cell_metrics(group: List[dict], cell: str) -> List[dict]:
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def cell(man: dict, name: str) -> dict:
    """The cell `name` with its end-to-end and per-layer metrics."""
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise ManifestError(f"no cell {name!r} in BENCHMARK.json (have {[w['name'] for w in man['workloads']]})")
    w = dict(found[0])
    w["end_to_end"] = _cell_metrics(man["end_to_end"], name)
    w["per_layer"] = _cell_metrics(man["per_layer"], name)
    w["config_file"] = next(c["file"] for c in man["configs"] if c["name"] == w["config"])
    return w


def read_json(bench_dir: pathlib.Path, kind: str, name: str) -> dict:
    """`<bench_dir>/<kind>/<name>.json`, found by name."""
    _name(name, kind)
    path = pathlib.Path(bench_dir) / kind / f"{name}.json"
    if not path.is_file():
        raise ManifestError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def _load(path: pathlib.Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(bench_dir: pathlib.Path, name: str):
    """The `read(obs)` function of `<bench_dir>/metrics/<name>.py`, or, for a
    name `<quantity>.<kind>` with no file of its own, of
    `metrics/<quantity>.py`."""
    _name(name, "metric")
    folder = pathlib.Path(bench_dir) / "metrics"
    paths = [folder / f"{name}.py"] + ([folder / f"{name.rsplit('.', 1)[0]}.py"] if "." in name else [])
    path = next((p for p in paths if p.is_file()), None)
    if path is None:
        raise ManifestError(f"no reader {paths[0]} for the per-layer metric {name!r}")
    return _load(path, f"benchmark_metric_{path.stem.replace('.', '_')}").read


def loop_class(bench_dir: pathlib.Path, kind: str):
    """The `Loop` class of `<bench_dir>/harness/loops/<kind>.py`, which runs
    the mixes of that kind."""
    _name(kind, "loop")
    path = pathlib.Path(bench_dir) / "harness" / "loops" / f"{kind}.py"
    if not path.is_file():
        raise ManifestError(f"no loop {path} for the mix kind {kind!r}")
    return _load(path, f"benchmark_loop_{kind.replace('.', '_')}").Loop


def config_of(bench_dir: pathlib.Path, cell_entry: dict) -> dict:
    path = pathlib.Path(bench_dir).parent / cell_entry["config_file"]
    if not path.is_file():
        raise ManifestError(f"no configuration file {path}")
    return json.loads(path.read_text())


def limits_of(bench_dir: pathlib.Path, cell_name: str) -> Optional[Dict[str, dict]]:
    return read_json(bench_dir, "limits", cell_name)["numbers"]
