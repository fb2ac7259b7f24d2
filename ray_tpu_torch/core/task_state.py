"""Per-attempt task lifecycle FSM shared by emitters and the state index.

Role-equivalent to the reference's rpc::TaskStatus enum + GcsTaskManager's
per-task lifecycle index (src/ray/gcs/gcs_server/gcs_task_manager.h, state
transitions in common/task/task_spec.h TaskStatus): every task *attempt*
walks an explicit state machine instead of an ad-hoc bag of event kinds —

    PENDING_ARGS_AVAIL -> PENDING_NODE_ASSIGNMENT -> SUBMITTED_TO_WORKER
        -> RUNNING -> FINISHED | FAILED{error_type}

The worker emits one task event per transition through its TaskEventBuffer
(worker.py `_task_event`); the controller folds those events into a bounded
per-(task_id, attempt) index (controller.py `_index_task_event`) that the
state API (`ray_tpu_torch.state`, `raytpu list tasks`, `/api/tasks`) queries.

Why a *rank fold* rather than strict transition enforcement at the index:
events for one attempt arrive from TWO reporters (the caller owns
submission/dispatch/finish, the executing worker owns exec start/end) whose
buffers flush on independent ticks, so the controller can legally observe
RUNNING before SUBMITTED_TO_WORKER. The fold keeps the furthest-progressed
state (terminal states always win); the TRANSITIONS table remains the
ground truth that tests validate every emitter against.
"""
from __future__ import annotations

# Attempt states (reference: rpc::TaskStatus).
PENDING_ARGS_AVAIL = "PENDING_ARGS_AVAIL"
PENDING_NODE_ASSIGNMENT = "PENDING_NODE_ASSIGNMENT"
SUBMITTED_TO_WORKER = "SUBMITTED_TO_WORKER"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"

STATES = (
    PENDING_ARGS_AVAIL,
    PENDING_NODE_ASSIGNMENT,
    SUBMITTED_TO_WORKER,
    RUNNING,
    FINISHED,
    FAILED,
)
TERMINAL = frozenset((FINISHED, FAILED))

# Monotone progress rank: the index folds out-of-order arrivals (two
# reporters, independent flush ticks) by keeping the highest rank.
ORDER = {s: i for i, s in enumerate(STATES)}

# Legal direct transitions (the emitters' contract; validated by tests).
# Skips are legal where an intermediate state has no observable window:
# a dep-free task is never PENDING_ARGS_AVAIL, and a FAILED can strike
# from any non-terminal state (lease infeasible, worker lost, dep failure).
TRANSITIONS = {
    PENDING_ARGS_AVAIL: {PENDING_NODE_ASSIGNMENT, FAILED},
    PENDING_NODE_ASSIGNMENT: {SUBMITTED_TO_WORKER, FAILED},
    SUBMITTED_TO_WORKER: {RUNNING, FINISHED, FAILED},
    RUNNING: {FINISHED, FAILED},
    FINISHED: set(),
    FAILED: set(),
}

# Event kind -> FSM state. A None state is a known lifecycle kind that
# carries timing/attribution but no transition (exec_end: execution is
# over, yet ok-vs-error is only known when the caller absorbs the reply).
EVENT_STATE = {
    "task_pending_args": PENDING_ARGS_AVAIL,
    "task_submitted": PENDING_NODE_ASSIGNMENT,
    "task_dispatched": SUBMITTED_TO_WORKER,
    "task_exec_start": RUNNING,
    "task_exec_end": None,
    "task_finished": FINISHED,  # FAILED when the event carries status=error
    "task_failed": FAILED,
}

# _event kinds that are deliberately NOT task-lifecycle transitions (spans,
# point events, recovery bookkeeping). The lint test asserts every kind
# worker.py emits lands in EVENT_STATE or here — an unknown kind is a bug.
NON_LIFECYCLE_KINDS = frozenset(("span", "object_recovery"))


def event_state(ev: dict) -> str | None:
    """The FSM state an event asserts, or None (timing-only / non-lifecycle)."""
    kind = ev.get("kind", "")
    state = EVENT_STATE.get(kind)
    if state is FINISHED and ev.get("status") == "error":
        return FAILED
    return state


def fold(record: dict, ev: dict) -> None:
    """Fold one lifecycle event into a per-attempt index record (in place).

    Monotone: state only advances in ORDER rank (terminal wins over
    anything), so reporter-interleaved arrival orders converge to the same
    record. Attribution fields (node/worker/fn/trace) fill in from whichever
    event carries them first; per-state timestamps land in `times`.
    """
    kind = ev.get("kind", "")
    state = event_state(ev)
    ts = ev.get("ts", 0.0)
    times = record.setdefault("times", {})
    if state is not None:
        cur = record.get("state")
        if cur is None or (ORDER[state] > ORDER[cur] and cur not in TERMINAL):
            record["state"] = state
        times.setdefault(state, ts)
    if kind == "task_exec_end":
        times.setdefault("exec_end", ts)
    # event_state already maps finished+status=error to FAILED.
    if state == FAILED and ev.get("error_type"):
        record["error_type"] = ev["error_type"]
    # NB: the generic "worker" field on an event names its EMITTER — for
    # caller-side events that is the submitting worker, so executor
    # attribution comes only from "exec_worker" (dispatch) or exec events.
    for src, dst in (
        ("fn", "fn"), ("node", "node_id"), ("exec_worker", "worker_id"),
        ("job", "job_id"), ("caller", "caller"),
        ("trace_id", "trace_id"), ("parent_id", "parent_id"),
    ):
        v = ev.get(src)
        if v and not record.get(dst):
            record[dst] = v
    # The executing worker's own id beats the caller's view (exec events are
    # the ground truth of where the attempt actually ran).
    if kind in ("task_exec_start", "task_exec_end"):
        if ev.get("worker"):
            record["worker_id"] = ev["worker"]
        if ev.get("node"):
            record["node_id"] = ev["node"]
