"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics; each
cell's workload file names its configuration, traffic mix and entry; every
piece is a file of its own under ``h100_bench/``:

- ``configs/<config>.json``: the model's published widths and settings;
- ``traffic/<traffic>.json``: the parameters the one generator reads;
- ``workloads/<cell>.json``: the cell's configuration, traffic and entry;
- ``entries/<entry>.py``: the code that drives one kind of program call;
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``flops/<config>.py``: the configuration's operations per unit of work.

A later cell or metric is a new file; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


def module(kind: str, name: str):
    """The module ``h100_bench/<kind>/<name>.py`` (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"h100_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path | None = None) -> dict:
    with open((root or ROOT) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: those
    whose ``workloads`` list it; an end-to-end metric without the list is
    every cell's (``setup_s``), a per-layer one every cell's that reports
    the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer
