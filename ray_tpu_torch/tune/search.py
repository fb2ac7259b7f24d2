"""Search spaces + variant generation (grid / random sampling).

Role-equivalent to the reference's basic variant generator and sample domains
(python/ray/tune/search/basic_variant.py,
tune/search/sample.py): a param_space dict may contain `grid_search([...])`
markers (cross-producted) and Domain objects (sampled per trial), nested
arbitrarily in dicts.
"""
from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Optional


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError

    def perturb(self, value, rng: random.Random):
        """PBT explore step: nudge a value inside the domain."""
        return self.sample(rng)


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)

    def perturb(self, value, rng):
        out = value * rng.choice([0.8, 1.2])
        return min(max(out, self.low), self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self.low, self.high = low, high
        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._lo, self._hi))

    def perturb(self, value, rng):
        out = value * rng.choice([0.8, 1.2])
        return min(max(out, self.low), self.high)


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)

    def perturb(self, value, rng):
        out = int(round(value * rng.choice([0.8, 1.2])))
        return min(max(out, self.low), self.high - 1)


class Choice(Domain):
    def __init__(self, categories: list):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> Randint:
    return Randint(low, high)


def choice(categories: list) -> Choice:
    return Choice(categories)


def sample_from(fn: Callable[[dict], Any]) -> "SampleFrom":
    return SampleFrom(fn)


class SampleFrom(Domain):
    """Callable domain: fn(spec_so_far) -> value (reference: tune.sample_from)."""

    def __init__(self, fn):
        self.fn = fn

    def sample(self, rng):  # resolved later with the partial config
        raise RuntimeError("SampleFrom is resolved with the trial config")


def grid_search(values: list) -> dict:
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _walk(space: dict, path=()):  # yields (path, value)
    for k, v in space.items():
        p = path + (k,)
        if isinstance(v, dict) and not _is_grid(v):
            yield from _walk(v, p)
        else:
            yield p, v


def _set_path(d: dict, path: tuple, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _copy_structure(space: dict) -> dict:
    out = {}
    for k, v in space.items():
        if isinstance(v, dict) and not _is_grid(v):
            out[k] = _copy_structure(v)
        else:
            out[k] = v
    return out


def generate_variants(param_space: dict, num_samples: int = 1,
                      seed: Optional[int] = None) -> list[dict]:
    """Expand grid_search cross-products x num_samples random draws."""
    rng = random.Random(seed)
    grid_items = [(p, v["grid_search"]) for p, v in _walk(param_space)
                  if _is_grid(v)]
    grid_paths = [p for p, _ in grid_items]
    grid_values = [vals for _, vals in grid_items]
    combos = list(itertools.product(*grid_values)) if grid_items else [()]

    configs: list[dict] = []
    for _ in range(num_samples):
        for combo in combos:
            cfg = _copy_structure(param_space)
            for p, val in zip(grid_paths, combo):
                _set_path(cfg, p, val)
            deferred = []
            for p, v in list(_walk(cfg)):
                if isinstance(v, SampleFrom):
                    deferred.append((p, v))
                elif isinstance(v, Domain):
                    _set_path(cfg, p, v.sample(rng))
                elif _is_grid(v):
                    pass  # already substituted
            for p, v in deferred:
                _set_path(cfg, p, v.fn(cfg))
            configs.append(cfg)
    return configs


def mutate_config(config: dict, mutations: dict, rng: random.Random) -> dict:
    """PBT explore: perturb the keys named in `mutations` (Domain -> perturb,
    list -> random choice, callable -> fresh value)."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in config.items()}
    for key, spec in mutations.items():
        cur = out.get(key)
        if isinstance(spec, Domain):
            out[key] = spec.perturb(cur, rng)
        elif isinstance(spec, list):
            out[key] = rng.choice(spec)
        elif callable(spec):
            out[key] = spec()
        else:
            raise TypeError(f"unsupported mutation spec for {key!r}: {spec}")
    return out
