"""KV-cache-aware routing structures for the serve handle.

Reference analogue: PrefixCacheAffinityRouter (prefix_aware_router.py:39 —
requests sharing a prompt prefix land on the replica whose vLLM engine
caches those KV blocks). Here the same idea rides the existing sticky-pin
machinery, with two deliberate unifications:

* ONE :class:`AffinityMap` holds every sticky pin kind — multiplexed model
  ids ("m:"), explicit affinity keys ("k:"), and prompt-prefix digests
  ("p:") — instead of two parallel LRU caches. One cap, one counted
  eviction (``serve.routing.affinity_evicted``): an evicted pin costs a
  model reload or a cold prefill on the next request for that key, so the
  eviction rate is an operator signal (graftlint counted-trims).
* the prefix key is a digest of the PROMPT HEAD only
  (:func:`prefix_digest`): two prompts sharing their first
  ``PREFIX_HEAD_TOKENS`` tokens (the canonical shared-system-prompt
  workload) map to the same key and therefore to the replica whose engine
  prefix-cache already holds those pages — exactly the granularity the
  engine caches at. The digest is tenant-scoped by the caller (same
  prefix, different tenant => different pin) so one tenant's flood cannot
  evict another's warm pin by key collision.

Routing order in the handle: prefix pin -> affinity pin -> power-of-two
choices on queue depth, counted per pick on
``serve.routing.cache_hit_total{kind=prefix|affinity|p2c}``.
"""
from __future__ import annotations

import hashlib
import json
from collections import OrderedDict
from typing import Callable, Optional

# How much of the prompt participates in the prefix key. Tokens beyond the
# head differentiate requests that share a system prompt — exactly the ones
# that SHOULD land on the same replica.
PREFIX_HEAD_TOKENS = 64
PREFIX_HEAD_CHARS = 256
# Only bodies that plausibly carry an LLM prompt are parsed (the proxy calls
# prefix_key_for_body on every request; a JSON parse per non-LLM POST would
# be hot-path waste).
_BODY_SNIFF_BYTES = 4096
# Bodies beyond this skip the JSON parse entirely and digest a raw byte
# head instead: parsing a multi-hundred-KB long-prompt body per request
# just to hash its first 64 tokens is O(body) proxy CPU on exactly the
# workload prefix routing targets. The raw-head digest is coarser (byte-
# identical heads only) but the shared-system-prompt case — one client
# library emitting the same serialized head — still keys identically.
_PARSE_MAX_BYTES = 64 * 1024


def prefix_digest(head) -> str:
    """Stable short digest of a prompt head: a list of token ids or a
    string. The same head always maps to the same key across processes."""
    if isinstance(head, str):
        data = head[:PREFIX_HEAD_CHARS].encode()
    else:
        data = ",".join(str(int(t)) for t in head[:PREFIX_HEAD_TOKENS]).encode()
    return hashlib.sha1(data).hexdigest()[:16]


def prefix_key_for_body(body: bytes, tenant: str = "") -> str:
    """Best-effort prefix key for a proxied request body: JSON with a
    ``tokens`` (token ids) or ``prompt`` (text) field yields the digest of
    its head, anything else yields "" (no prefix routing). Cheap sniff
    before the parse; parse failures are silent — prefix routing is an
    optimization, never a correctness gate."""
    if not body or body[:1] != b"{":
        return ""
    sniff = body[:_BODY_SNIFF_BYTES]
    if b'"tokens"' not in sniff and b'"prompt"' not in sniff:
        return ""
    if len(body) > _PARSE_MAX_BYTES:
        digest = hashlib.sha1(sniff).hexdigest()[:16]
        return f"{tenant}:{digest}" if tenant else digest
    try:
        payload = json.loads(body)
    except Exception:
        return ""
    head = payload.get("tokens") or payload.get("prompt")
    if not head:
        return ""
    try:
        digest = prefix_digest(head)
    except Exception:
        return ""
    return f"{tenant}:{digest}" if tenant else digest


class AffinityMap:
    """LRU-bounded sticky map key -> replica name. NOT thread-safe: owned
    by the handle's ``_ReplicaSet`` and only touched under its lock (the
    same contract as FairWaitQueue).

    The cap is enforced PER KEY KIND (the namespace prefix before ":"):
    high-cardinality prompt-prefix keys ("p:") churn at their own cap and
    can never LRU-thrash out the multiplexed-model pins ("m:") — the
    failure the old two-separate-caches design was immune to, preserved
    here inside one map with one eviction metric.

    ``on_evict`` fires once per cap eviction (the handle binds it to the
    ``serve.routing.affinity_evicted`` counter); ``evicted`` tallies them
    locally too so a map is inspectable without the metrics registry."""

    def __init__(self, cap: int = 1024,
                 on_evict: Optional[Callable[[], None]] = None):
        self.cap = int(cap)  # per key kind
        self._map: "OrderedDict[str, str]" = OrderedDict()
        self._kind_counts: dict = {}
        self._on_evict = on_evict
        self.evicted = 0  # counted trim: cap evictions are never silent

    @staticmethod
    def _kind(key: str) -> str:
        return key.partition(":")[0]

    def __len__(self) -> int:
        return len(self._map)

    def get(self, key: str) -> Optional[str]:
        """Sticky replica for ``key`` (refreshes LRU recency), or None."""
        replica = self._map.get(key)
        if replica is not None:
            self._map.move_to_end(key)
        return replica

    def _del(self, key: str) -> None:
        del self._map[key]
        kind = self._kind(key)
        n = self._kind_counts.get(kind, 1) - 1
        if n:
            self._kind_counts[kind] = n
        else:
            self._kind_counts.pop(kind, None)

    def pin(self, key: str, replica: str) -> None:
        if key in self._map:
            self._map.pop(key)
            self._map[key] = replica
            return
        kind = self._kind(key)
        self._map[key] = replica
        self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
        while self._kind_counts[kind] > self.cap:
            # Evict the least-recently-used key of the SAME kind (walks past
            # other kinds' entries; bounded by the map's total size, which
            # is itself bounded at kinds x cap).
            victim = next(k for k in self._map if self._kind(k) == kind)
            self._del(victim)
            self.evicted += 1
            if self._on_evict is not None:
                self._on_evict()

    def release_replica(self, replica: str) -> int:
        """Drop every pin to ``replica`` (it died / left the membership);
        returns how many were released. A release is a pin whose target is
        gone — not a cap eviction, so it does not count there."""
        stale = [k for k, r in self._map.items() if r == replica]
        for k in stale:
            self._del(k)
        return len(stale)

    def retain(self, live) -> int:
        """Keep only pins to replicas in ``live``; returns released count."""
        stale = [k for k, r in self._map.items() if r not in live]
        for k in stale:
            self._del(k)
        return len(stale)

    def snapshot(self) -> dict:
        return {"size": len(self._map), "cap": self.cap, "evicted": self.evicted,
                "by_kind": dict(self._kind_counts)}
