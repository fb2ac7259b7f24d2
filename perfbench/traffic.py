"""The one generator of serving traffic: it reads a mix's parameters
(``traffic/<mix>.json``) and makes the requests of a run from the seed.

Per run the count of requests and the multiset of their lengths are fixed
by the mix and the window's length alone: lengths are the distribution's
quantiles at evenly spaced probabilities. The seed shuffles them, places the
arrivals and draws the prompts' token ids, so two seeds give the same work
in another order.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Optional

import numpy as np

from perfbench.harness import seed_for


@dataclasses.dataclass
class Request:
    idx: int
    prompt: np.ndarray  # int32 token ids
    max_tokens: int
    due_s: Optional[float] = None  # open loop: seconds after the window opens


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """n lengths: the distribution's quantiles at (i + 0.5) / n, clipped to
    [min, max]. "uniform" is over the whole numbers min..max; "lognormal"
    has the given median and sigma (of the log)."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "uniform":
        out = lo + np.floor(u * (hi - lo + 1))
    elif dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        out = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(out, lo, hi).astype(np.int64)


def _prompts(lengths, vocab: int, rng) -> list:
    flat = rng.integers(0, vocab, int(np.sum(lengths)), dtype=np.int32)
    return np.split(flat, np.cumsum(lengths)[:-1])


def open_loop(mix: dict, seed: int, seconds: float, vocab: int, rate: Optional[float] = None) -> list:
    """Requests due in a window of ``seconds``: rate x seconds arrivals
    (rounded), placed uniformly at random in the window (Poisson arrivals
    conditioned on their count), in due order."""
    rate = mix["arrivals"]["rate_per_s"] if rate is None else rate
    n = max(1, int(round(rate * seconds)))
    due = np.sort(np.random.default_rng(seed_for(seed, "arrivals")).uniform(0.0, seconds, n))
    rng = np.random.default_rng(seed_for(seed, "lengths"))
    plen = rng.permutation(quantile_lengths(mix["prompt_len"], n))
    olen = rng.permutation(quantile_lengths(mix["output_len"], n))
    prompts = _prompts(plen, vocab, np.random.default_rng(seed_for(seed, "prompts")))
    return [Request(i, prompts[i], int(olen[i]), float(due[i])) for i in range(n)]


def backlog(mix: dict, seed: int, vocab: int, first_wave: int) -> list:
    """A fixed pool of ``mix["pool"]`` requests for an offline backlog, in
    submission order. The first ``first_wave`` take their answer lengths
    from ``first_wave_output_len`` (staggered, so the slots they fill turn
    over at spread times); the rest from ``output_len``."""
    n = int(mix["pool"])
    rng = np.random.default_rng(seed_for(seed, "lengths"))
    plen = rng.permutation(quantile_lengths(mix["prompt_len"], n))
    first = rng.permutation(quantile_lengths(mix["first_wave_output_len"], first_wave))
    rest = rng.permutation(quantile_lengths(mix["output_len"], n - first_wave))
    olen = np.concatenate([first, rest])
    prompts = _prompts(plen, vocab, np.random.default_rng(seed_for(seed, "prompts")))
    return [Request(i, prompts[i], int(olen[i])) for i in range(n)]


def judge_sample(done: list, seed: int, min_tokens: int) -> list:
    """Indices into ``done`` (items with ``prompt`` and ``tokens``) to
    compare: the longest (prompt plus answer) first, then others drawn from
    the seed until their answers hold ``min_tokens`` tokens."""
    if not done:
        return []
    order = list(np.random.default_rng(seed_for(seed, "judge")).permutation(len(done)))
    longest = max(range(len(done)), key=lambda i: (len(done[i]["prompt"]) + len(done[i]["tokens"]), -i))
    picked = [longest]
    total = len(done[longest]["tokens"])
    for i in order:
        if total >= min_tokens:
            break
        if i != longest:
            picked.append(int(i))
            total += len(done[i]["tokens"])
    return picked
