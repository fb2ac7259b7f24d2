"""Metrics API: Counter / Gauge / Histogram, a per-process registry.

Counterpart of ``ray_tpu/util/metrics.py``, stdlib only. Every series lives
in this process's registry; ``snapshot`` dumps it and ``prometheus_text``
renders a list of dumped series. Nothing ships the registry to a controller
yet: the port has no runtime, so, as in the reference with no core worker,
the series stay in the process that records them.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Optional

_lock = threading.Lock()
_registry: dict[tuple, "_Metric"] = {}  # (name, sorted label items) -> metric


class _Metric:
    KIND = "?"

    def __init__(self, name: str, description: str = "", tag_keys: tuple = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: dict = {}

    def set_default_tags(self, tags: dict):
        self._default_tags = dict(tags)
        return self

    def _series(self, tags: Optional[dict]):
        merged = {**self._default_tags, **(tags or {})}
        key = (self.name, tuple(sorted(merged.items())))
        with _lock:
            series = _registry.get(key)
            if series is None:
                series = _registry[key] = _Series(self, merged)
            return series


class _Series:
    def __init__(self, metric: _Metric, tags: dict):
        self.metric = metric
        self.tags = tags
        self.value = 0.0
        self.buckets: Optional[list] = None
        self.counts: Optional[list] = None
        self.sum = 0.0
        self.n = 0


class Counter(_Metric):
    KIND = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None):
        s = self._series(tags)
        with _lock:
            s.value += value


class Gauge(_Metric):
    KIND = "gauge"

    def set(self, value: float, tags: Optional[dict] = None):
        s = self._series(tags)
        with _lock:
            s.value = float(value)


class Histogram(_Metric):
    KIND = "histogram"

    def __init__(self, name: str, description: str = "", boundaries: Optional[list] = None, tag_keys: tuple = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or [0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60])

    def observe(self, value: float, tags: Optional[dict] = None):
        _observe_locked(self._series(tags), value)

    def bind(self, tags: Optional[dict] = None) -> "_BoundHistogram":
        """Pre-resolve a tag set to its series: per-observe cost drops to a
        bisect under the lock (no tag-dict merge/sort) — for hot paths that
        record every task/request."""
        return _BoundHistogram(self._series(tags))


def _observe_locked(s: "_Series", value: float):
    """The one histogram-record implementation (Histogram.observe and every
    bound series share it)."""
    with _lock:
        if s.counts is None:
            s.buckets = list(s.metric.boundaries)
            s.counts = [0] * (len(s.buckets) + 1)
        s.counts[bisect.bisect_left(s.buckets, value)] += 1
        s.sum += value
        s.n += 1


class _BoundHistogram:
    __slots__ = ("_series",)

    def __init__(self, series: "_Series"):
        self._series = series

    def observe(self, value: float):
        _observe_locked(self._series, value)


def snapshot() -> list[dict]:
    """Serializable dump of this process's metric series."""
    out = []
    with _lock:
        for (_name, _tags), s in _registry.items():
            if s.metric.KIND == "histogram" and s.counts is None:
                continue  # bound but never observed: no data to ship
            rec = {
                "name": s.metric.name,
                "kind": s.metric.KIND,
                "description": s.metric.description,
                "tags": s.tags,
                "value": s.value,
                "ts": time.time(),
            }
            if s.counts is not None:
                rec["buckets"] = s.buckets
                rec["counts"] = list(s.counts)
                rec["sum"] = s.sum
                rec["n"] = s.n
            out.append(rec)
    return out


def _clear():
    with _lock:
        _registry.clear()


def _esc(value) -> str:
    """Escape a label value per the Prometheus exposition format."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(series: list[dict]) -> str:
    """Render aggregated series in Prometheus exposition format.

    Samples are grouped by metric name first: the exposition format requires
    every sample of a metric to sit contiguously under a single HELP/TYPE
    header, and the merged-series dict a controller hands us can interleave
    different metrics' samples (multi-reporter merge order)."""
    lines = []
    seen_help = set()
    # Stable sort: groups by name, preserves each metric's series order.
    for rec in sorted(series, key=lambda r: r["name"]):
        name = "raytpu_" + rec["name"].replace(".", "_").replace("-", "_")
        if name not in seen_help:
            help_text = str(rec.get("description", "")).replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {rec['kind']}")
            seen_help.add(name)
        labels = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(rec.get("tags", {}).items()))
        label_str = "{" + labels + "}" if labels else ""
        if rec["kind"] == "histogram":
            acc = 0
            sep = "," if labels else ""
            for b, c in zip(rec.get("buckets") or (), rec.get("counts") or ()):
                acc += c
                lines.append(f'{name}_bucket{{{labels}{sep}le="{b}"}} {acc}')
            total = sum(rec.get("counts") or ())
            lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {total}')
            lines.append(f"{name}_sum{label_str} {rec.get('sum', 0.0)}")
            lines.append(f"{name}_count{label_str} {total}")
        else:
            lines.append(f"{name}{label_str} {rec['value']}")
    return "\n".join(lines) + "\n"
