"""The chaos site catalog: every gate woven into the tree, what faults it
supports, and what recovery machinery the fault exercises.

Schedules are validated against this catalog (FaultSchedule.validate): a
concrete site pattern must name a row here and use one of its kinds, so a
typo'd schedule fails loud instead of injecting nothing. Site-name
uniqueness and the one-gate idiom are machine-enforced by graftlint rule
``chaos-gate``.
"""
from __future__ import annotations

# site name -> {layer, kinds, desc, exercises}
SITES: dict = {
    # -- L0: rpc transport ----------------------------------------------
    "rpc.frame.send": {
        "layer": "rpc",
        "kinds": {"drop", "duplicate", "truncate", "corrupt_mac"},
        "desc": "one envelope-lane frame about to hit the transport",
        "exercises": "peer MAC rejection + connection teardown; caller retry paths",
    },
    "rpc.raw.send": {
        "layer": "rpc",
        "kinds": {"stall", "drop"},
        "desc": "one raw-lane chunk frame (bulk object transfer)",
        "exercises": "pull chunk timeout -> per-chunk failover to an alternate source",
    },
    "rpc.recv.dispatch": {
        "layer": "rpc",
        "kinds": {"delay"},
        "desc": "one received envelope about to be dispatched",
        "exercises": "latency tolerance: timeouts, heartbeat grace, reply ordering",
    },
    "rpc.stream.item": {
        "layer": "rpc",
        "kinds": {"drop", "delay"},
        "desc": "one generator_items batch frame about to ship to the stream consumer",
        "exercises": "drop: the frame is lost with its transport (conn torn down) -> "
                     "caller's connection-loss retry resubmits and the replay's "
                     "duplicate indices dedup; delay: slow token-stream tolerance",
    },
    "collective.ring.send": {
        "layer": "collective",
        "kinds": {"drop", "corrupt", "delay"},
        "desc": "one ring-collective raw frame about to ship to the successor "
                "(drop: never reaches the wire; corrupt: ships under a "
                "poisoned key — the discarded-after-integrity-failure shape, "
                "since a real bit flip is rejected by the raw lane's MAC "
                "with the connection; delay: slow link)",
        "exercises": "step-deadline -> typed CollectiveError (never a hang) + "
                     "abort fan-out around the ring so every blocked rank "
                     "fails with the origin attributed (scenario "
                     "ring_link_loss); delay: step-timeout tolerance",
    },
    # -- L2: node daemon / object plane ---------------------------------
    "node.chunk.serve": {
        "layer": "node",
        "kinds": {"evict", "error"},
        "desc": "a raw-lane chunk read being served from this node's arena",
        "exercises": "evict: object loss under a borrower -> directory fallback + "
                     "lineage reconstruction; error: chunk retry / source failover",
    },
    "node.pull.source": {
        "layer": "node",
        "kinds": {"error"},
        "desc": "puller side, before fetching a chunk from a chosen source",
        "exercises": "mid-object source death -> striped failover to alternates",
    },
    "node.spill.pread": {
        "layer": "node",
        "kinds": {"error"},
        "desc": "ranged read of a spilled object's file",
        "exercises": "fail-loud truncated-spill path (no silent short chunks)",
    },
    "node.worker.lease": {
        "layer": "node",
        "kinds": {"kill", "hang"},
        "desc": "a worker lease just granted to a submitter",
        "exercises": "worker death mid-task (delayed SIGKILL) or stall (SIGSTOP): "
                     "task retry on a fresh worker, daemon death reporting",
    },
    "tpu.preempt": {
        "layer": "accel",
        "kinds": {"preempt"},
        "desc": "TPU-preemption notice check (consulted each daemon heartbeat)",
        "exercises": "node drain + death -> gang/actor reschedule, autoscaler "
                     "replacement of the preempted slice host",
    },
    # -- L3: core worker -------------------------------------------------
    "worker.task.submit": {
        "layer": "worker",
        "kinds": {"error"},
        "desc": "a task entering the submission queue (PENDING state)",
        "exercises": "submission-time failure -> task returns fail cleanly, "
                     "FSM record closes terminal",
    },
    "worker.task.dispatch": {
        "layer": "worker",
        "kinds": {"error"},
        "desc": "a task batch about to be pushed to a leased worker",
        "exercises": "simulated worker loss at dispatch -> retry/backoff path "
                     "without killing anything",
    },
    "worker.exec": {
        "layer": "worker",
        "kinds": {"error", "delay", "kill"},
        "desc": "a normal task about to execute on this worker",
        "exercises": "error: RemoteError propagation + retries; delay: slow-executor "
                     "stalls; kill: hard worker death mid-task (os._exit)",
    },
    "worker.actor.exec": {
        "layer": "worker",
        "kinds": {"error", "delay"},
        "desc": "an actor method call about to execute",
        "exercises": "actor call failure/latency; caller-side reply handling",
    },
    # -- L4: serve data plane ---------------------------------------------
    "serve.replica.slow": {
        "layer": "serve",
        "kinds": {"delay"},
        "desc": "one request about to execute on a serve replica (injected "
                "per-request exec delay, after the deadline gate)",
        "exercises": "QoS plane under slow replicas: fair-queue buildup, "
                     "queue-delay-driven AIMD shedding at the proxy, deadline "
                     "expiry at every hop, interactive goodput under overload "
                     "(scenario overload_storm)",
    },
    "scale.replica.start": {
        "layer": "serve",
        "kinds": {"delay", "error"},
        "desc": "the serve controller about to start one replica (delayed "
                "or failed startup: slow provisioning, image pulls)",
        "exercises": "scale plane under slow capacity arrival: the policy's "
                     "flip cooldown (no upscale->downscale oscillation while "
                     "a replica is slow to arrive — scenario autoscale_flap), "
                     "reconcile retry of failed starts",
    },
    # -- L4.5: replay plane (the load generator is part of the system) ----
    "replay.request.send": {
        "layer": "replay",
        "kinds": {"drop", "delay"},
        "desc": "one trace record about to be fired by the open-loop "
                "replayer (drop: client-side loss, the request never "
                "reaches the wire; delay: client network flap before send)",
        "exercises": "ingress under lossy/laggy clients: goodput accounting "
                     "distinguishes client loss from server shed, late "
                     "arrivals ride the same deadline machinery (scenario "
                     "day_in_the_life)",
    },
    # -- L5.5: elastic train plane ----------------------------------------
    "elastic.reshard.transfer": {
        "layer": "elastic",
        "kinds": {"drop", "delay", "error"},
        "desc": "one live-reshard raw frame about to ship from a parked "
                "export to a pulling rank (drop: never reaches the wire; "
                "error: the fetch RPC fails typed; delay: slow source)",
        "exercises": "receiver part-deadline -> typed ElasticTransferError, "
                     "failed source's runs re-planned onto alternate "
                     "replicas (multi-source failover); an uncoverable "
                     "window falls back to the checkpoint-restore restart "
                     "(scenario elastic_preempt)",
    },
    # -- L5: checkpoint & weight-publication plane ------------------------
    "ckpt.chunk.write": {
        "layer": "ckpt",
        "kinds": {"error"},
        "desc": "one content-addressed chunk about to be written to the chunk tier",
        "exercises": "save-attempt abort: the manifest never commits, new "
                     "chunks of the attempt are reclaimed, no torn chunk is "
                     "ever visible under a valid digest",
    },
    "ckpt.worker.kill_mid_save": {
        "layer": "ckpt",
        "kinds": {"kill", "error"},
        "desc": "a worker between arrays of its shard save (its part is never acked)",
        "exercises": "coordinator commit protocol: missing ack discards the "
                     "whole attempt, idempotent chunks already written are "
                     "reclaimed unless an older manifest shares them",
    },
    "ckpt.publish.swap": {
        "layer": "ckpt",
        "kinds": {"delay", "error"},
        "desc": "a replica about to hot-swap fetched+verified weights in place",
        "exercises": "delay: old weights keep serving until the swap completes "
                     "(no torn read); error: failed swap keeps old weights and "
                     "retries on the next publish/poll",
    },
    # -- L1: controller ---------------------------------------------------
    "controller.heartbeat": {
        "layer": "controller",
        "kinds": {"drop"},
        "desc": "a node heartbeat arriving at the controller",
        "exercises": "heartbeat-loss tolerance vs the node-death timeout",
    },
    "controller.lease.grant": {
        "layer": "controller",
        "kinds": {"delay", "error"},
        "desc": "a worker-lease request being granted",
        "exercises": "lease-grant latency and failure -> submitter retry loop",
    },
}


def catalog() -> list:
    """Rows for the CLI / README: (site, layer, kinds, description)."""
    return [
        {"site": name, "layer": row["layer"], "kinds": sorted(row["kinds"]),
         "desc": row["desc"], "exercises": row["exercises"]}
        for name, row in sorted(SITES.items())
    ]
