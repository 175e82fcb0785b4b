"""Everything a run reads by name: its cell in ``BENCHMARK.json``, the cell's
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``) and limits of the output check
(``limits/<cell>.json``), the kind of loop the mix names
(``loops/<kind>.py``), and the reader of each per-layer metric
(``metrics/<metric>.py``, a module with ``read(run) -> float | None``).

A new configuration, mix, kind of loop, cell or metric is a new file and a
new entry: no file here changes. ``root`` is the benchmark's folder; tests
pass another.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with what it reads."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: tuple  # names of the end-to-end metrics this cell reports
    per_layer: tuple  # names of the per-layer metrics this cell reports
    units: dict  # metric name -> unit


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT,
              benchmark: pathlib.Path = None) -> Cell:
    """The cell ``name`` of the benchmark file (default: ``BENCHMARK.json``
    beside ``root``), with its configuration, traffic and limits read by
    name from under ``root``."""
    bench = _load_json(benchmark or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in the benchmark (have {sorted(cells)})")
    entry = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(
        name=name,
        config=_load_json(root / "configs" / f"{entry['config']}.json"),
        traffic=_load_json(root / "traffic" / f"{entry['traffic']}.json"),
        limits=_load_json(root / "limits" / f"{name}.json"),
        chips=int(entry["chips"]),
        end_to_end=tuple(m["name"] for m in e2e),
        per_layer=tuple(m["name"] for m in layer),
        units={m["name"]: m["unit"] for m in e2e + layer},
    )


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module(root / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_")).read


def loop_kind(name: str, root: pathlib.Path = ROOT):
    """The module ``loops/<name>.py`` (see ``portbench/loops``): the
    benchmark's own as the package module, another root's by its path."""
    if root == ROOT:
        return importlib.import_module(f"portbench.loops.{name}")
    return _module(root / "loops" / f"{name}.py", f"portbench.loops.{name}_{id(root)}")
