"""Replay buffers: uniform + prioritized, plus the buffer actor that sits
between async collectors and the learner.

Role-equivalent to the reference's replay-buffer utilities
(rllib/utils/replay_buffers/ — ReplayBuffer, PrioritizedReplayBuffer with
sum-segment-tree sampling and importance weights) re-shaped for the actor
runtime: collectors push transition batches INTO a ReplayBufferActor
(actor-to-actor calls, no driver hop), the learner samples out of it, and
cooperative backpressure bounds how far collection may run ahead of learning
(the reference bounds this with its training-intensity / native-ratio
machinery).
"""
from __future__ import annotations

import threading

import numpy as np


class SumTree:
    """Binary-indexed sum tree over leaf priorities: O(log n) update and
    prefix-sum sampling (the standard proportional-PER structure)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.size = 1
        while self.size < self.capacity:
            self.size *= 2
        self.tree = np.zeros(2 * self.size, np.float64)

    def set(self, idx, priority):
        idx = np.asarray(idx, np.int64)
        priority = np.asarray(priority, np.float64)
        pos = idx + self.size
        self.tree[pos] = priority
        # Walk each touched path up; vectorized over unique parents per level.
        while len(pos) and pos[0] > 1:
            pos = np.unique(pos // 2)
            self.tree[pos] = self.tree[2 * pos] + self.tree[2 * pos + 1]

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def get(self, idx):
        return self.tree[np.asarray(idx, np.int64) + self.size]

    def sample(self, prefix_sums) -> np.ndarray:
        """Vectorized descent: leaf index whose cumulative range contains each
        prefix sum."""
        s = np.asarray(prefix_sums, np.float64).copy()
        pos = np.ones(len(s), np.int64)
        while pos[0] < self.size:
            left = 2 * pos
            left_sum = self.tree[left]
            go_right = s > left_sum
            s = np.where(go_right, s - left_sum, s)
            pos = np.where(go_right, left + 1, left)
        return pos - self.size


class ReplayBuffer:
    """Uniform transition buffer: dict-of-ring-arrays, allocated lazily from
    the first batch's shapes/dtypes."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self.rng = np.random.default_rng(seed)
        self._store: dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        # The buffer actor runs with max_concurrency > 1 (concurrent
        # collector pushes + learner samples). Every mutation/read of the
        # ring state happens under this lock, so a sample can never observe
        # a partially-allocated store (the round-4 KeyError: 'actions' race
        # was two first-push threads splitting the lazy allocation).
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: dict) -> int:
        with self._lock:
            return self._add_batch(batch)

    def sample(self, batch_size: int) -> dict | None:
        with self._lock:
            return self._sample(batch_size)

    def update_priorities(self, indices, priorities) -> None:
        with self._lock:
            self._update_priorities(indices, priorities)

    def _add_batch(self, batch: dict) -> int:
        n = len(next(iter(batch.values())))
        if not self._store:
            for k, v in batch.items():
                v = np.asarray(v)
                self._store[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)
        return self._on_added(idx, batch)

    def _on_added(self, idx, batch) -> int:
        return self._size

    def _sample(self, batch_size: int) -> dict | None:
        if self._size == 0:
            return None
        idx = self.rng.integers(0, self._size, batch_size)
        out = {k: v[idx] for k, v in self._store.items()}
        out["indices"] = idx
        out["weights"] = np.ones(batch_size, np.float32)
        return out

    def _update_priorities(self, indices, priorities) -> None:
        pass  # uniform: no-op


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER (Schaul et al.): P(i) ~ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta / max w (reference:
    rllib/utils/replay_buffers/prioritized_episode_buffer sampling scheme)."""

    # TD magnitudes are clipped into the priority range: a diverging update's
    # inf/nan TD must not poison the tree total (uniform(0, inf) explodes).
    MAX_PRIORITY = 100.0

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.tree = SumTree(self.capacity)
        self._max_priority = 1.0

    def _on_added(self, idx, batch) -> int:
        # New transitions get max priority: every experience is seen at least
        # once before TD error demotes it.
        self.tree.set(idx, np.full(len(idx), self._max_priority ** self.alpha))
        return self._size

    def _sample(self, batch_size: int) -> dict | None:
        if self._size == 0 or self.tree.total <= 0:
            return None
        # Stratified prefix sums de-correlate the draw.
        bounds = np.linspace(0.0, self.tree.total, batch_size + 1)
        s = self.rng.uniform(bounds[:-1], bounds[1:])
        idx = self.tree.sample(s)
        idx = np.minimum(idx, self._size - 1)
        probs = np.maximum(self.tree.get(idx) / self.tree.total, 1e-12)
        weights = (self._size * probs) ** (-self.beta)
        weights = (weights / weights.max()).astype(np.float32)
        out = {k: v[idx] for k, v in self._store.items()}
        out["indices"] = idx
        out["weights"] = weights
        return out

    def _update_priorities(self, indices, priorities) -> None:
        priorities = np.abs(np.asarray(priorities, np.float64))
        priorities = np.where(np.isfinite(priorities), priorities, self.MAX_PRIORITY)
        priorities = np.clip(priorities, 0.0, self.MAX_PRIORITY) + self.eps
        self._max_priority = max(self._max_priority, float(priorities.max()))
        self.tree.set(np.asarray(indices, np.int64), priorities ** self.alpha)


class ReplayBufferActor:
    """The buffer as a service between collector actors and the learner.

    Backpressure: `add_batch` returns {"size", "throttle"}; throttle flips on
    when collection has run more than `max_ahead_ratio` transitions ahead of
    what the learner has sampled (after warmup). Collectors pause briefly
    when throttled — learning throughput, not env throughput, paces the
    system (reference: training-intensity control).
    """

    def __init__(self, capacity: int, prioritized: bool = False,
                 alpha: float = 0.6, beta: float = 0.4, seed: int = 0,
                 max_ahead_ratio: float = 8.0, warmup: int = 1000):
        self.buf = (
            PrioritizedReplayBuffer(capacity, alpha=alpha, beta=beta, seed=seed)
            if prioritized else ReplayBuffer(capacity, seed=seed)
        )
        self.added = 0
        self.sampled = 0
        self.max_ahead_ratio = max_ahead_ratio
        self.warmup = warmup
        self.add_times: list[float] = []  # for overlap diagnostics/tests
        # The actor runs with max_concurrency > 1; the backpressure counters
        # are read-modify-write state and need the same atomicity as the
        # ring buffer itself.
        self._counter_lock = threading.Lock()

    def add_batch(self, batch: dict) -> dict:
        import time

        n = len(next(iter(batch.values())))
        self.buf.add_batch(batch)
        with self._counter_lock:
            self.added += n
            self.add_times.append(time.monotonic())
            throttle = (
                self.added > self.warmup
                and self.added > self.sampled * self.max_ahead_ratio
            )
        return {"size": len(self.buf), "throttle": throttle}

    def sample(self, batch_size: int):
        out = self.buf.sample(batch_size)
        if out is not None:
            with self._counter_lock:
                self.sampled += batch_size
        return out

    def update_priorities(self, indices, priorities) -> bool:
        self.buf.update_priorities(indices, priorities)
        return True

    def stats(self) -> dict:
        return {
            "size": len(self.buf),
            "added": self.added,
            "sampled": self.sampled,
            "add_times": list(self.add_times),
        }
