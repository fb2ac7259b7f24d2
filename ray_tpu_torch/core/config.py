"""Typed config flags with environment-variable overrides.

TPU-native analogue of the reference's RAY_CONFIG macro system
(src/ray/common/ray_config_def.h): every flag is declared once
with a type and default, and can be overridden with a ``RAYTPU_<NAME>``
environment variable. The head node's config is propagated to all nodes via
the controller KV at startup (see controller.py), matching the reference's
head-config propagation (python/ray/_private/node.py:1338).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any

_ENV_PREFIX = "RAYTPU_"


def _coerce(ty, raw: str):
    if ty is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    if ty in (dict, list):
        return json.loads(raw)
    return raw


@dataclass
class Config:
    # --- transport / rpc ---
    heartbeat_interval_s: float = 0.5
    # Generous: worker-spawn bursts can starve the event loop on small hosts;
    # TCP connection loss catches hard failures much sooner anyway.
    heartbeat_timeout_s: float = 15.0
    rpc_connect_timeout_s: float = 10.0
    rpc_retry_delay_s: float = 0.1
    # --- objects ---
    # Objects at or below this many bytes are inlined in RPC replies instead of
    # going through the shared-memory store (reference: max_direct_call_object_size,
    # ray_config_def.h).
    max_inline_object_size: int = 100 * 1024
    object_store_memory: int = 256 * 1024 * 1024
    object_chunk_size: int = 1024 * 1024
    object_spill_dir: str = ""
    # --- object transfer plane (PullManager, node.py) ---
    # Chunks kept in flight per pulled object: fills the bandwidth-delay
    # product instead of stop-and-wait (reference: ObjectManager pipelined
    # chunk reads, max_chunks_in_flight).
    pull_window_chunks: int = 8
    # Transfer-plane chunk size (raw-lane pulls). Larger than
    # object_chunk_size on purpose: the streaming lane's per-chunk fixed
    # cost (request envelope, ack, admission, frame headers) is pure
    # overhead, and with windowed pipelining + per-chunk failover a 4 MiB
    # retry unit is still cheap. object_chunk_size (1 MiB) remains the
    # legacy pickled-chunk and inline-promotion threshold.
    pull_chunk_size: int = 4 * 1024 * 1024
    # Global pull admission: whole-object pulls admitted concurrently per
    # daemon, and total chunk bytes in flight across them — bulk transfer
    # must not starve the control plane (reference: PullManager admission
    # by available object-store memory).
    max_concurrent_pulls: int = 4
    max_inflight_pull_bytes: int = 64 * 1024 * 1024
    # Per-chunk deadline; on expiry the source connection is dropped (it may
    # be mid-frame) and the chunk retries against an alternate replica.
    pull_chunk_timeout_s: float = 30.0
    # Raw-lane MAC granularity on authenticated links: "window" MACs once
    # per pull window (one control RPC + one HMAC finalize per
    # pull_window_chunks run; tamper detection still covers every byte —
    # a flipped bit anywhere fails the WHOLE window typed and it refetches
    # per-chunk), "chunk" keeps the v3 per-4MiB-frame tag (finer retry
    # unit, one RPC round trip per chunk). Peers that predate the window
    # RPC are detected per connection and served per-chunk automatically.
    raw_mac_granularity: str = "window"
    # Vectored raw-lane sends (one sendmsg syscall per frame + direct
    # socket writes that bypass the transport's buffer copy). Off = the
    # pre-wire-speed sequential-write path; exists so bench_core can A/B
    # the legacy wire shape in-process.
    raw_vectored_send: bool = True
    # Degraded-network shaping for the raw data lane, cluster-propagated:
    # JSON {"rate_mb_s": X, "delay_ms": Y} token-bucket pacing applied at
    # every raw-frame send (the socketpair-throttle fallback of the bench's
    # netem profile — used when tc/CAP_NET_ADMIN is unavailable). Empty =
    # wire speed.
    net_shape_spec: str = ""
    # --- streaming generators (the token path of serve/LLM responses) ---
    # Bound on items buffered per stream between the producing generator and
    # the loop-side pump that ships them as batched generator_items frames.
    # The producer blocks (backpressure) when the buffer is full; the pump
    # ships whatever is pending each time it runs, so a lone item still
    # flushes the tick it is produced (TTFT unaffected). Larger values
    # deepen batches for fast producers at the cost of more buffered values.
    stream_buffer_items: int = 32
    # --- workers ---
    num_workers_soft_limit: int = 0  # 0 => num_cpus
    worker_register_timeout_s: float = 30.0
    worker_start_timeout_s: float = 60.0
    idle_worker_killing_time_s: float = 300.0
    # OOM worker killing (reference: raylet memory monitor +
    # worker_killing_policy, default threshold 0.95 at 250ms cadence;
    # <= 0 disables the monitor).
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_s: float = 0.25
    # --- scheduling ---
    scheduler_spread_threshold: float = 0.5
    max_pending_lease_requests_per_key: int = 10
    # With an autoscaler attached, currently-infeasible demand must PARK (the
    # autoscaler provisions a node for it) instead of failing fast — the
    # reference always parks and warns; fast-fail is this framework's default
    # for static clusters.
    infeasible_as_pending: bool = False
    # --- actors ---
    # Generous: an actor __init__ may compile models (LLM replica warmup on
    # TPU takes minutes); the daemon is async, so a slow construct doesn't
    # block its other RPCs.
    actor_creation_timeout_s: float = 600.0
    max_actor_restarts_default: int = 0
    # --- failure handling ---
    task_retry_delay_s: float = 0.05
    max_task_retries_default: int = 3
    lineage_max_bytes: int = 64 * 1024 * 1024
    # Grace period after a controller restart for daemons to re-confirm
    # restored-ALIVE actors before the restart FSM declares their workers lost.
    controller_reconcile_grace_s: float = 10.0
    # --- logging/metrics ---
    log_dir: str = ""
    metrics_report_interval_s: float = 5.0
    event_buffer_size: int = 10000
    # --- state introspection (task lifecycle FSM -> controller index) ---
    # Emit per-attempt task lifecycle events (worker.py _task_event). Off,
    # the state API sees no tasks (tracing still works); the flag exists so
    # the pipeline's cost can be A/B'd (bench_core detail.state_overhead).
    task_events_enabled: bool = True
    # Debounce window for the early lifecycle-event flush: a transition
    # reaches the controller within this bound instead of the metrics tick.
    task_event_flush_interval_s: float = 0.5
    # Per-task state index bound on the controller ((task_id, attempt)
    # records); overflow evicts terminal-first and counts tasks_evicted.
    task_index_size: int = 8192
    # --- QoS / overload protection (serve proxy + handle; ray_tpu_torch/qos) ---
    # Master switch for the proxy's ADAPTIVE ADMISSION (AIMD concurrency
    # limit + class-tiered shedding with 429s). Off, the proxy admits
    # everything — the plane-OFF baseline for the overload_goodput bench.
    # The fair admission queue and deadline gates are structural (always on:
    # with no RequestContext they cost one ContextVar.get per hop).
    qos_enabled: bool = True
    # CoDel-style queue-delay target: if even the window's MINIMUM observed
    # handle-admission delay exceeds this, a standing queue exists and the
    # limit backs off multiplicatively; otherwise it probes up additively.
    qos_target_delay_s: float = 0.1
    qos_min_concurrency: int = 4
    qos_max_concurrency: int = 1024
    qos_initial_concurrency: int = 64
    qos_adapt_interval_s: float = 0.5
    # --- checkpoint & weight-publication plane (ray_tpu_torch/ckpt/) ---
    # Content-addressed chunk size for sharded saves. Matches the pull
    # path's chunk granularity by default: one checkpoint chunk is one
    # ranged read on restore, one transfer unit when it moves cross-host.
    ckpt_chunk_size: int = 4 * 1024 * 1024
    # Recovery cadence for replica weight subscriptions: the pubsub push is
    # the fast path, this poll catches replicas whose subscription missed a
    # publish (controller restart, dropped conn).
    ckpt_poll_interval_s: float = 2.0
    # --- collectives (ring transport + train-plane gradient sync) ---
    # Gradient-bucket target size for the train plane's bucketed overlap
    # (train/grad_sync.py): leaves pack into ~this many bytes per bucket and
    # each bucket's ring allreduce launches as soon as the bucket fills.
    collective_bucket_bytes: int = 4 * 1024 * 1024
    # Raw-frame part size for one ring step's payload: chunks larger than
    # this split into several keyed frames (bounds per-frame memory and
    # keeps any single frame well under the transport's _MAX_FRAME cap).
    collective_part_bytes: int = 8 * 1024 * 1024
    # Per-step deadline on the ring: a lost/rejected frame surfaces as a
    # typed CollectiveError within this bound (never a hang), and the abort
    # fans around the ring so every blocked rank fails attributed.
    collective_ring_step_timeout_s: float = 30.0
    # Block size for int8 quantized allreduce (elements per fp32 absmax
    # scale). 256 => 1.6% wire overhead for scales at 4x payload shrink.
    collective_quant_block: int = 256
    # --- elastic train plane (live N->M reshard, ray_tpu_torch/elastic/) ---
    # Raw-frame part size for one reshard run's payload (same role as
    # collective_part_bytes on the ring lane).
    elastic_part_bytes: int = 4 * 1024 * 1024
    # Per-source deadline for a live-reshard pull: a dead/stalled source
    # fails typed within this bound and its runs re-plan onto alternates.
    elastic_transfer_timeout_s: float = 30.0
    # --- chaos (deterministic fault injection; see ray_tpu_torch/chaos/) ---
    # JSON FaultSchedule spec ({"seed": N, "rules": [...]}) armed in EVERY
    # process of the session: the head pushes it with the rest of the config
    # (daemons/workers install at registration) and spawned workers also get
    # it via RAYTPU_CHAOS_SPEC env so faults arm before their first task.
    # Empty (the default) keeps the chaos plane entirely off — the gate is a
    # single attribute load + None check (bench detail.chaos_overhead).
    chaos_spec: str = ""
    # --- observability plane (flight recorder / SLO engine; ray_tpu_torch/obs/) ---
    # Per-process flight-recorder ring capacity (events). The recorder only
    # tees events other planes already emit, so the knob trades post-mortem
    # depth against resident memory, never request-path cost.
    obs_flight_ring: int = 4096
    # Dump directory. Empty -> <tempdir>/raytpu_flight for drivers; node
    # daemons override per-worker via RAYTPU_FLIGHT_DIR to <log_dir>/flight
    # so last-gasp dumps land next to the worker logs they explain.
    obs_flight_dir: str = ""
    # Deadline-storm dump trigger: this many qos expiries inside the window
    # dumps the ring (the process is missing deadlines wholesale; the ring
    # currently holds why).
    obs_storm_expiries: int = 50
    obs_storm_window_s: float = 5.0
    # Event-loop lag probe cadence (obs/health.py); 0 disables the probe.
    # Spikes past obs_loop_spike_s drop a thread dump into the recorder.
    obs_loop_probe_interval_s: float = 0.25
    obs_loop_spike_s: float = 0.25
    # Declarative SLOs armed at controller start: JSON list of objective
    # specs (see obs/slo.py docstring). The serve API / `raytpu slo` can
    # add more at runtime.
    slo_spec: str = ""
    # Controller SLO evaluation cadence: each tick samples the merged
    # reporter series into every objective's window and re-judges burn rates.
    slo_eval_interval_s: float = 1.0
    # Continuous wall-clock sampler (obs/profiler.py): every core process
    # runs a daemon thread walking sys._current_frames at this rate, folding
    # stacks into a bounded counted accumulator with per-plane attribution.
    # ~19 Hz by default (prime-ish: never phase-locks onto 10/20/50ms
    # periodic work); 0 disarms the sampler everywhere (RAYTPU_PROFILE_HZ).
    profile_hz: float = 19.0
    # Distinct collapsed stacks each accumulator retains; overflow drops the
    # incoming stack's samples, counted (samples_dropped / stacks_evicted).
    profile_max_stacks: int = 2048
    # Window ring: the sampler folds finished epochs of profile_epoch_s into
    # a bounded ring of profile_window_epochs (alert-triggered captures and
    # /api/profile's default view read this window, not all-time totals).
    profile_epoch_s: float = 5.0
    profile_window_epochs: int = 24
    # Per-trace profile scopes held per process (trace-id -> accumulator,
    # oldest evicted counted). Populated only for TRACED exec spans.
    profile_max_traces: int = 64
    # --- security ---
    # OPT-IN per-session shared secret for the RPC layer (pickle-over-TCP
    # executes code on unpickle; with a token set, every frame carries an
    # HMAC verified before unpickling). Set it (or RAYTPU_AUTH_TOKEN) before
    # cluster start; workers/jobs inherit it via env. Empty (the default)
    # runs WITHOUT authentication — fine for localhost dev, not for
    # multi-host deployments.
    auth_token: str = ""
    # --- tpu ---
    tpu_chips_per_host_default: int = 4
    # --- networking ---
    # Bind/advertise IP for every server this process opens (controller,
    # node daemon, workers). 127.0.0.1 keeps single-host sessions loopback;
    # a multi-host deployment passes the host's routable IP (CLI
    # `start --node-ip` / RAYTPU_NODE_IP) so peers on other hosts can dial
    # object-transfer and worker-to-worker connections (reference:
    # --node-ip-address, scripts.py).
    node_ip: str = "127.0.0.1"

    def apply_env(self):
        for f in fields(self):
            raw = os.environ.get(_ENV_PREFIX + f.name.upper())
            if raw is not None:
                setattr(self, f.name, _coerce(f.type if isinstance(f.type, type) else type(getattr(self, f.name)), raw))
        return self

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    # Fields that are NODE identity, not cluster policy: adopt_cluster
    # preserves the local value when a head pushes its config down.
    PER_NODE_FIELDS = ("node_ip",)

    def adopt_cluster(self, d: dict) -> "Config":
        """Adopt the head's cluster-wide config, keeping this process's
        per-node fields (every daemon/worker calls this at registration)."""
        cfg = Config.from_dict(d)
        for f in self.PER_NODE_FIELDS:
            setattr(cfg, f, getattr(self, f))
        return cfg

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        for k, v in d.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env()
    return _global_config


def set_config(cfg: Config):
    global _global_config
    _global_config = cfg
