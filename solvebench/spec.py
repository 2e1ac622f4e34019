"""Finding a cell's parts by the names `BENCHMARK.json` gives them.

Every part of a cell is a file of its own under the benchmark's folder,
found by name, so that a new configuration, traffic mix, matrix, cost
function or per-layer metric is a new file and no edit:

    configs/<config>.json     the configuration as it is run
    traffic/<traffic>.json    the traffic mix's parameters
    matrices/<generator>.py   `generate(**params)` → CSR arrays
    costs/<name>.py           operation and byte counts of one function
    metrics/<metric>.py       `read(ctx)` → the metric's value or None

Modules are loaded from their file path, so a name may hold `.` and `-`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    """`BENCHMARK.json` at the root of the checkout."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload '{name}' in BENCHMARK.json; have "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config '{name}' in BENCHMARK.json")


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that the cell reports: those
    without a `workloads` list, and those whose list names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(root: Path, bench: dict, name: str) -> dict:
    """The configuration file that `BENCHMARK.json` names for `name`."""
    return _json(root / config_entry(bench, name)["file"])


def load_traffic(base: Path, name: str) -> dict:
    return _json(base / "traffic" / f"{name}.json")


def load_module(base: Path, kind: str, name: str):
    """`<base>/<kind>/<name>.py` as a module of its own."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} '{name}': no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"solvebench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
