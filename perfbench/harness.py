"""The benchmark's machinery, driven by data.

``BENCHMARK.json`` names the cells; everything that belongs to one
configuration, traffic mix or metric sits in a file of its own, found by
name:

- ``configs/<file>.json``: the model configuration as it is run (the
  manifest's ``file``).
- ``traffic/<traffic>.json``: the mix's parameters; its ``entry`` names the
  driver of the window, ``entries/<entry>.py``.
- ``metrics/<metric>.py``: the reader of one metric (end to end or per
  layer). A name without a file of its own falls back to the longest dotted
  prefix that has one (``engine.step_ms.rag`` -> ``engine.step_ms.py``).
- ``limits/<workload>.json``: the limits of the comparison that decides
  ``correct``.
- ``models/<model_type>.py`` and ``reference/<model_type>.py``: for the
  configuration's ``model_type``, the port's keywords, the weights' leaves and
  the counts of that block, and its plain reference (``models/__init__.py``).

A reader is ``read(rec) -> float | None``; ``None`` means it found nothing
to read, and the metric is left out of the line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

# Top-level module names that must never be loaded where the port is
# measured: the JAX package, JAX itself and its companions. Compared whole,
# so "ray_tpu_torch" (the measured port) is not "ray_tpu".
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names present in ``modules`` (sys.modules)."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def manifest(path: Optional[Path] = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """Imports a file of the benchmark by path (names may hold dots)."""
    name = name or "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_for(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run: every input the
    run makes (weights, prompts, arrivals, batches) draws from its own."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *stream.encode()]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file as it is run
    traffic_name: str
    traffic: dict
    end_to_end: list  # manifest entries of the metrics this cell reports
    per_layer: list
    limits: dict
    root: Path = HERE  # where the files named by type are found

    def _by_type(self, kind: str):
        mtype = self.config.get("model_type")
        if not mtype:
            raise ValueError(f"configuration {self.config_name!r} has no model_type")
        path = self.root / kind / f"{mtype}.py"
        if not path.is_file():
            rel = path.relative_to(self.root.parent).as_posix()
            raise FileNotFoundError(f"model_type {mtype!r} of configuration {self.config_name!r} has no {rel}: add it")
        return load_module(path, f"perfbench_{kind}_{mtype}")

    def model(self):
        """The model type's module (``models/<model_type>.py``)."""
        return self._by_type("models")

    def reference(self):
        """The model type's plain reference (``reference/<model_type>.py``)."""
        return self._by_type("reference")

    def model_kwargs(self) -> dict:
        return self.model().port_kwargs(self.config)


def _applies(metric: dict, cell: str, e2e_names=()) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, man: Optional[dict] = None, root: Path = HERE) -> Cell:
    """The cell ``name`` of the manifest, with the files it names found
    under ``root`` (the benchmark's directory; configuration files by their
    path from its parent)."""
    man = man or manifest()
    wl = next((w for w in man["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    config = load_json(root.parent / cfg_entry["file"])
    traffic = load_json(root / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name, names)]
    limits_path = root / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name, int(wl["chips"]), wl["config"], config, wl["traffic"], traffic, e2e, per_layer, limits, root)


def metric_reader(name: str):
    """The ``read`` function of metric ``name``: ``metrics/<name>.py``, else
    the longest dotted prefix of the name that has a file."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return load_module(path).read
    raise FileNotFoundError(f"no reader for metric {name!r} under perfbench/metrics/")


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers: the cell, the host-side
    series the entry recorded (``host``), the set-up time, and the reduced
    device trace of a traced run."""
    cell: Cell
    setup_s: float = 0.0
    host: dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None  # trace.TraceSummary


def read_metrics(rec: Record, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
