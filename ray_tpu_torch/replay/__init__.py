"""Day-in-the-life replay plane: trace-driven load against a live cluster.

Three pieces, composed by the ``day_in_the_life`` chaos scenario:

* :mod:`ray_tpu_torch.replay.trace` — versioned JSONL workload traces + a seeded
  synthesizer (same seed => byte-identical file);
* :mod:`ray_tpu_torch.replay.runner` — an open-loop replayer that fires records
  at trace-faithful arrival times onto the QoS ingress headers;
* :mod:`ray_tpu_torch.replay.timeline` — a declarative, phase-anchored chaos
  timeline compiled onto the seeded :class:`~ray_tpu_torch.chaos.plan.FaultSchedule`
  plus wall-clock control-plane actions.

The run's observability exhaust is folded into one diffable report by
:mod:`ray_tpu_torch.obs.ledger`.
"""
from ray_tpu_torch.replay.runner import Replayer, summarize
from ray_tpu_torch.replay.timeline import CompiledTimeline, Timeline, TimelineDriver
from ray_tpu_torch.replay.trace import (default_params, dumps_trace, envelope,
                                  phase_spans, read_trace, synthesize,
                                  trace_sha256, write_trace)

__all__ = [
    "CompiledTimeline", "Replayer", "Timeline", "TimelineDriver",
    "default_params", "dumps_trace", "envelope", "phase_spans", "read_trace",
    "summarize", "synthesize", "trace_sha256", "write_trace",
]
