"""graftlint, the port's own copy (``ray_tpu_torch.analysis``): the AST
invariant checker for the async runtime.

``tests/test_graftlint.py`` against the port: per-rule fixtures (firing /
clean / suppressed-with-reason / suppressed-without-reason), with fixture
paths and sources naming ``ray_tpu_torch/``, plus the whole-tree regression
gate: ``ray_tpu_torch/`` is always at ZERO findings. Re-introducing a bare
``asyncio.create_task`` fire-and-forget fails both the gate here and
``python -m ray_tpu_torch lint``. (``LINT.json`` reports the reference tree
only; nothing here writes it.)
"""
import os
import textwrap

import pytest

import ray_tpu_torch
from ray_tpu_torch.analysis import (
    BAD_SUPPRESSION,
    UNUSED_SUPPRESSION,
    lint_paths,
    lint_source,
)

PKG_DIR = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
REPO_ROOT = os.path.dirname(PKG_DIR)


def _lint(src: str, path: str = "fixture.py"):
    return lint_source(textwrap.dedent(src), path)


def _rules_hit(result):
    return {f.rule for f in result.findings}


# ---------------------------------------------------------------------------
# bg-strong-ref
# ---------------------------------------------------------------------------

def test_bg_strong_ref_fires_on_dropped_task():
    r = _lint("""
        import asyncio

        async def f():
            asyncio.create_task(g())
            asyncio.ensure_future(h())
            loop.create_task(i())
    """)
    assert [f.line for f in r.findings if f.rule == "bg-strong-ref"] == [5, 6, 7]


def test_bg_strong_ref_quiet_when_retained():
    r = _lint("""
        import asyncio

        async def f(registry):
            t = asyncio.create_task(g())            # assigned AND used below
            self._task = asyncio.create_task(h())   # attribute
            registry.add(asyncio.create_task(i()))  # nested in a call
            await asyncio.create_task(j())          # awaited
            await t
            return asyncio.ensure_future(k())       # returned
    """)
    assert "bg-strong-ref" not in _rules_hit(r)


def test_bg_strong_ref_loop_carried_handle_is_used():
    """Cancel-previous/start-next: the load sits ABOVE the assignment but
    both live in the same loop — that is a use."""
    r = _lint("""
        import asyncio

        async def pump():
            t = None
            while True:
                if t is not None:
                    await t
                t = asyncio.create_task(g())
    """)
    assert "bg-strong-ref" not in _rules_hit(r)


def test_mac_before_pickle_recv_into_taints_the_buffer():
    r = _lint("""
        import pickle

        async def read_loop(loop, sock):
            buf = bytearray(1024)
            await loop.sock_recv_into(sock, buf)
            return pickle.loads(buf)
    """)
    assert "mac-before-pickle" in _rules_hit(r)


def test_bg_strong_ref_tuple_targets_and_load_order():
    # Tuple-positional assignment with no later use fires per dropped name.
    r = _lint("""
        import asyncio

        async def handler():
            t, u = asyncio.create_task(a()), asyncio.create_task(b())
    """)
    assert len([f for f in r.findings if f.rule == "bg-strong-ref"]) == 2
    # A load BEFORE the assignment is not a later use.
    r = _lint("""
        import asyncio

        async def handler():
            t = None
            print(t)
            t = asyncio.create_task(foo())
    """)
    assert "bg-strong-ref" in _rules_hit(r)


def test_bg_strong_ref_assigned_but_never_used_local():
    """A local only pins the task while the frame lives — assign-and-forget
    (or a mechanical `_ = create_task(...)`) is the bare-Expr bug aliased."""
    r = _lint("""
        import asyncio

        async def handler():
            t = asyncio.create_task(g())
            return True
    """)
    hits = [f for f in r.findings if f.rule == "bg-strong-ref"]
    assert len(hits) == 1 and "'t'" in hits[0].message
    # A use from a nested def (closure) counts.
    r = _lint("""
        import asyncio

        async def handler():
            t = asyncio.create_task(g())

            def on_done():
                t.cancel()

            register(on_done)
    """)
    assert "bg-strong-ref" not in _rules_hit(r)


def test_bg_strong_ref_suppressed_with_reason():
    r = _lint("""
        import asyncio

        async def f():
            asyncio.create_task(g())  # graftlint: disable=bg-strong-ref  droppable: best-effort cache warm
    """)
    assert "bg-strong-ref" not in _rules_hit(r)
    assert len(r.suppressions) == 1
    assert "cache warm" in r.suppressions[0].reason


def test_bg_strong_ref_suppression_without_reason_still_fails():
    r = _lint("""
        import asyncio

        async def f():
            asyncio.create_task(g())  # graftlint: disable=bg-strong-ref
    """)
    # The original finding survives AND the reasonless disable is reported.
    assert _rules_hit(r) == {"bg-strong-ref", BAD_SUPPRESSION}
    assert not r.suppressions


# ---------------------------------------------------------------------------
# no-blocking-in-async
# ---------------------------------------------------------------------------

def test_no_blocking_fires_inside_async_def():
    r = _lint("""
        import subprocess
        import time

        async def f(fut):
            time.sleep(1)
            subprocess.run(["ls"])
            fut.result(timeout=5)
    """)
    lines = [f.line for f in r.findings if f.rule == "no-blocking-in-async"]
    assert lines == [6, 7, 8]


def test_no_blocking_quiet_in_sync_and_executor_thunks():
    r = _lint("""
        import asyncio
        import time

        def sync_path():
            time.sleep(1)  # sync function: its caller owns the thread

        async def f(loop, fut):
            await asyncio.sleep(1)
            fut.result()  # bare result() on a done future is legal

            def thunk():
                time.sleep(1)  # nested sync def: runs on an executor thread

            await loop.run_in_executor(None, thunk)
    """)
    assert "no-blocking-in-async" not in _rules_hit(r)


def test_no_blocking_quiet_in_lambda_bodies():
    """A lambda body is deferred code — the idiomatic executor offload
    `run_in_executor(None, lambda: blocking())` must lint clean."""
    r = _lint("""
        import subprocess
        import time

        async def f(loop):
            await loop.run_in_executor(None, lambda: subprocess.run(["ls"]))
            cb = lambda: time.sleep(1)
            return cb
    """)
    assert "no-blocking-in-async" not in _rules_hit(r)


def test_no_blocking_quiet_in_decorators_and_defaults():
    """Decorator arguments and parameter defaults run at DEFINITION time on
    the defining thread — not inside the coroutine."""
    r = _lint("""
        import time

        @retry(delay=time.sleep(0))
        async def f(x=time.sleep(0)):
            pass
    """)
    assert "no-blocking-in-async" not in _rules_hit(r)


def test_no_blocking_suppression_cases():
    ok = _lint("""
        import time

        async def f():
            time.sleep(0)  # graftlint: disable=no-blocking-in-async  yields GIL only; sub-us by design
    """)
    assert "no-blocking-in-async" not in _rules_hit(ok)
    bad = _lint("""
        import time

        async def f():
            time.sleep(0)  # graftlint: disable=no-blocking-in-async
    """)
    assert _rules_hit(bad) == {"no-blocking-in-async", BAD_SUPPRESSION}


# ---------------------------------------------------------------------------
# mac-before-pickle
# ---------------------------------------------------------------------------

def test_mac_before_pickle_fires_on_unverified_wire_bytes():
    r = _lint("""
        import pickle

        async def read_loop(reader):
            data = await reader.readexactly(100)
            return pickle.loads(data)
    """)
    assert [f.line for f in r.findings if f.rule == "mac-before-pickle"] == [6]


def test_mac_before_pickle_quiet_when_verified_first():
    r = _lint("""
        import hmac
        import pickle

        async def read_loop(reader):
            data = await reader.readexactly(100)
            tag, body = data[:16], data[16:]
            if not hmac.compare_digest(tag, compute_tag(body)):
                return None
            return pickle.loads(body)

        def not_wire_data(blob):
            return pickle.loads(blob)  # not tainted: no socket read here
    """)
    assert "mac-before-pickle" not in _rules_hit(r)


def test_mac_before_pickle_taint_propagates_through_assignments():
    r = _lint("""
        import pickle

        async def read_loop(reader):
            raw = await reader.readexactly(100)
            view = memoryview(raw)
            body = view[16:]
            return pickle.loads(body)
    """)
    assert "mac-before-pickle" in _rules_hit(r)


def test_mac_before_pickle_tracks_taint_groups_separately():
    """Verifying ONE read must not whitelist a different, never-verified
    read later in the same function (per-taint-group dominance, not a
    function-global verified flag)."""
    r = _lint("""
        import hmac
        import pickle

        async def read_loop(reader):
            hdr = await reader.readexactly(16)
            if not hmac.compare_digest(hdr, expected_tag()):
                return None
            payload = await reader.readexactly(1000)  # second, unverified read
            return pickle.loads(payload)
    """)
    assert "mac-before-pickle" in _rules_hit(r)
    # And the verified group stays clean when both reads are bound by the
    # same verify call (tag compared against a digest of the payload).
    r = _lint("""
        import hmac
        import pickle

        async def read_loop(reader):
            tag = await reader.readexactly(16)
            payload = await reader.readexactly(1000)
            if not hmac.compare_digest(tag, digest_of(payload)):
                return None
            return pickle.loads(payload)
    """)
    assert "mac-before-pickle" not in _rules_hit(r)


def test_mac_before_pickle_direct_read_expression():
    """No assignment needed: unpickling the read expression itself fires."""
    r = _lint("""
        import pickle

        async def read_loop(reader):
            return pickle.loads(await reader.readexactly(10))
    """)
    assert "mac-before-pickle" in _rules_hit(r)


def test_mac_before_pickle_length_from_verified_header_does_not_launder():
    """A payload read SIZED by a verified header is still new, unverified
    wire bytes."""
    r = _lint("""
        import hmac
        import pickle

        async def read_loop(reader):
            hdr = await reader.readexactly(20)
            if not hmac.compare_digest(hdr[:16], expected()):
                return None
            plen = int.from_bytes(hdr[16:], "little")
            payload = await reader.readexactly(plen)
            return pickle.loads(payload)
    """)
    assert "mac-before-pickle" in _rules_hit(r)


def test_mac_before_pickle_augassign_accumulation_loop():
    r = _lint("""
        import pickle

        async def read_loop(reader):
            buf = b""
            while True:
                buf += await reader.read(100)
                if done(buf):
                    break
            return pickle.loads(buf)
    """)
    assert "mac-before-pickle" in _rules_hit(r)


def test_mac_before_pickle_mixed_groups_stay_unverified():
    """Mixing a never-verified read into verified data poisons the result —
    it does not launder the unverified bytes."""
    r = _lint("""
        import hmac
        import pickle

        async def read_loop(reader):
            a = await reader.readexactly(16)
            if not hmac.compare_digest(a, tag()):
                return None
            b = await reader.readexactly(1000)
            c = a + b
            return pickle.loads(c)
    """)
    assert "mac-before-pickle" in _rules_hit(r)


def test_mac_before_pickle_tracks_instance_attributes():
    r = _lint("""
        import pickle

        async def read_loop(self, reader):
            self.buf = await reader.readexactly(100)
            return pickle.loads(self.buf)
    """)
    assert "mac-before-pickle" in _rules_hit(r)


def test_mac_before_pickle_reassignment_is_a_strong_update():
    """Rebinding a verified name to a FRESH read must not inherit the old
    group's verified status — the common receive-loop shape reuses names."""
    r = _lint("""
        import hmac
        import pickle

        async def read_loop(reader):
            data = await reader.readexactly(16)
            if not hmac.compare_digest(data, session_tag()):
                return None
            data = await reader.readexactly(1000)  # reuse of a verified name
            return pickle.loads(data)
    """)
    assert "mac-before-pickle" in _rules_hit(r)
    # And rebinding to clean data drops the taint entirely.
    clean = _lint("""
        import pickle

        async def read_loop(reader):
            data = await reader.readexactly(100)
            data = local_cache()
            return pickle.loads(data)
    """)
    assert "mac-before-pickle" not in _rules_hit(clean)


def test_mac_before_pickle_walrus_and_annotated_assign_taint():
    walrus = _lint("""
        import pickle

        async def read_loop(reader):
            while (data := await reader.readexactly(100)):
                yield pickle.loads(data)
    """)
    assert "mac-before-pickle" in _rules_hit(walrus)
    annotated = _lint("""
        import pickle

        async def read_loop(reader):
            data: bytes = await reader.readexactly(100)
            return pickle.loads(data)
    """)
    assert "mac-before-pickle" in _rules_hit(annotated)


def test_mac_before_pickle_suppression_cases():
    ok = _lint("""
        import pickle

        async def read_loop(reader):
            data = await reader.readexactly(100)
            return pickle.loads(data)  # graftlint: disable=mac-before-pickle  loopback-only diagnostic socket
    """)
    assert "mac-before-pickle" not in _rules_hit(ok)
    bad = _lint("""
        import pickle

        async def read_loop(reader):
            data = await reader.readexactly(100)
            return pickle.loads(data)  # graftlint: disable=mac-before-pickle
    """)
    assert _rules_hit(bad) == {"mac-before-pickle", BAD_SUPPRESSION}


# ---------------------------------------------------------------------------
# counted-trims
# ---------------------------------------------------------------------------

def test_counted_trims_fires_on_silent_slice_delete_and_evict_pop():
    r = _lint("""
        class Buf:
            def trim(self):
                del self.events[:100]

            def evict(self):
                self.index.pop(next(iter(self.index)))
    """)
    lines = [f.line for f in r.findings if f.rule == "counted-trims"]
    assert lines == [4, 7]


def test_counted_trims_ignores_unbounded_clear():
    """`del x[:]` clears/consumes everything — not a bounded eviction."""
    r = _lint("""
        class Buf:
            def reset(self):
                del self.pending[:]
    """)
    assert "counted-trims" not in _rules_hit(r)


def test_counted_trims_quiet_with_counter():
    r = _lint("""
        class Buf:
            def trim(self):
                self.events_dropped += 100
                del self.events[:100]

            def evict(self):
                self.index.pop(next(iter(self.index)))
                self.entries_evicted += 1

            def evict_metric(self):
                self.cache.pop(next(iter(self.cache)))
                self._cache_evicted.inc()
    """)
    assert "counted-trims" not in _rules_hit(r)


def test_counted_trims_deque_maxlen():
    silent = _lint("""
        from collections import deque

        class Buf:
            def __init__(self):
                self.recent = deque(maxlen=128)
    """)
    assert "counted-trims" in _rules_hit(silent)
    counted = _lint("""
        from collections import deque

        class Buf:
            def __init__(self):
                self.recent = deque(maxlen=128)

            def add(self, x):
                if len(self.recent) == self.recent.maxlen:
                    self.recent_dropped += 1
                self.recent.append(x)
    """)
    assert "counted-trims" not in _rules_hit(counted)
    unbounded = _lint("""
        from collections import deque

        q = deque(maxlen=None)
    """)
    assert "counted-trims" not in _rules_hit(unbounded)


def test_counted_trims_deque_positional_maxlen():
    """maxlen passed positionally — deque(iterable, N) — bounds the buffer
    exactly like the keyword form and must not slip past the rule (coverage
    gap found reviewing the streaming fast lane's bounded buffer)."""
    silent = _lint("""
        from collections import deque

        class Buf:
            def __init__(self):
                self.recent = deque([], 128)
    """)
    assert "counted-trims" in _rules_hit(silent)
    counted = _lint("""
        from collections import deque

        class Buf:
            def __init__(self):
                self.recent = deque([], 128)

            def add(self, x):
                if len(self.recent) == self.recent.maxlen:
                    self.recent_dropped += 1
                self.recent.append(x)
    """)
    assert "counted-trims" not in _rules_hit(counted)
    # deque(iterable) alone and an explicit positional None stay unbounded.
    unbounded = _lint("""
        from collections import deque

        a = deque(range(3))
        b = deque([], None)
    """)
    assert "counted-trims" not in _rules_hit(unbounded)


def test_counted_trims_fires_outside_functions_too():
    module_level = _lint("""
        CACHE = {}
        CACHE.pop(next(iter(CACHE)))
        del HISTORY[:100]
    """)
    lines = [f.line for f in module_level.findings if f.rule == "counted-trims"]
    assert lines == [3, 4]
    module_counted = _lint("""
        CACHE = {}
        CACHE.pop(next(iter(CACHE)))
        cache_evicted += 1
    """)
    assert "counted-trims" not in _rules_hit(module_counted)


def test_counted_trims_suppression_cases():
    ok = _lint("""
        class Buf:
            def consume(self):
                del self.buf[:4]  # graftlint: disable=counted-trims  consuming parsed bytes, not discarding data
    """)
    assert "counted-trims" not in _rules_hit(ok)
    # Closing-line placement on a black-formatted multi-line evict works too
    # (findings carry the statement's whole span, not just its first line).
    multiline = _lint("""
        class Buf:
            def evict(self):
                self.index.pop(
                    next(iter(self.index))
                )  # graftlint: disable=counted-trims  LRU routing hints, not data
    """)
    assert not multiline.findings and len(multiline.suppressions) == 1
    bad = _lint("""
        class Buf:
            def consume(self):
                del self.buf[:4]  # graftlint: disable=counted-trims
    """)
    assert _rules_hit(bad) == {"counted-trims", BAD_SUPPRESSION}


# ---------------------------------------------------------------------------
# loop-thread-race
# ---------------------------------------------------------------------------

_RACE_SRC = """
    class W:
        async def on_loop(self):
            self.state = "loop"

        def on_thread(self):
            self.state = "thread"{suffix}

        async def go(self, loop):
            await loop.run_in_executor(None, self.on_thread)
"""


def test_loop_thread_race_fires_without_lock():
    r = _lint(_RACE_SRC.format(suffix=""))
    hits = [f for f in r.findings if f.rule == "loop-thread-race"]
    assert len(hits) == 1 and hits[0].line == 7
    assert "self.state" in hits[0].message


def test_loop_thread_race_quiet_with_lock_or_without_dispatch():
    locked = _lint("""
        class W:
            async def on_loop(self):
                with self._lock:
                    self.state = "loop"

            def on_thread(self):
                with self._lock:
                    self.state = "thread"

            async def go(self, loop):
                await loop.run_in_executor(None, self.on_thread)
    """)
    assert "loop-thread-race" not in _rules_hit(locked)
    undispatched = _lint("""
        class W:
            async def on_loop(self):
                self.state = "loop"

            def plain_method(self):
                self.state = "sync"  # never handed to an executor
    """)
    assert "loop-thread-race" not in _rules_hit(undispatched)


def test_loop_thread_race_suppression_cases():
    ok = _lint(_RACE_SRC.format(
        suffix='  # graftlint: disable=loop-thread-race  single int store; torn reads impossible'
    ))
    assert "loop-thread-race" not in _rules_hit(ok)
    bad = _lint(_RACE_SRC.format(suffix="  # graftlint: disable=loop-thread-race"))
    assert _rules_hit(bad) == {"loop-thread-race", BAD_SUPPRESSION}


# ---------------------------------------------------------------------------
# fsm-emitter (path-scoped to core/worker.py)
# ---------------------------------------------------------------------------

_FSM_FULL = """
    class W:
        def run(self, spec):
            self._task_event("task_pending_args", spec)
            self._task_event("task_submitted", spec)
            self._task_event("task_dispatched", spec)
            self._task_event("task_exec_start", spec)
            self._task_event("task_finished", spec){extra}
"""


def test_fsm_emitter_fires_on_unmapped_kind():
    src = _FSM_FULL.format(extra='\n            self._task_event("task_went_sideways", spec)')
    r = _lint(src, path="fake/core/worker.py")
    hits = [f for f in r.findings if f.rule == "fsm-emitter"]
    assert len(hits) == 1 and "task_went_sideways" in hits[0].message


def test_fsm_emitter_quiet_on_mapped_kinds_and_scoped_to_worker():
    r = _lint(_FSM_FULL.format(extra=""), path="fake/core/worker.py")
    assert "fsm-emitter" not in _rules_hit(r)
    # Same unmapped kind outside core/worker.py: rule does not apply.
    src = _FSM_FULL.format(extra='\n            self._task_event("task_went_sideways", spec)')
    r = _lint(src, path="fake/other.py")
    assert "fsm-emitter" not in _rules_hit(r)


def test_fsm_emitter_coverage_check():
    # Dropping a whole lifecycle phase (no exec_start emitter) is a finding.
    r = _lint("""
        class W:
            def run(self, spec):
                self._task_event("task_finished", spec)
    """, path="fake/core/worker.py")
    hits = [f for f in r.findings if f.rule == "fsm-emitter"]
    assert hits and any("RUNNING" in f.message for f in hits)


def test_fsm_emitter_suppression_cases():
    src = _FSM_FULL.format(
        extra='\n            self._task_event("task_debug_probe", spec)'
              '  # graftlint: disable=fsm-emitter  debug-only kind, index ignores it on purpose'
    )
    r = _lint(src, path="fake/core/worker.py")
    assert "fsm-emitter" not in _rules_hit(r)
    src = _FSM_FULL.format(
        extra='\n            self._task_event("task_debug_probe", spec)'
              '  # graftlint: disable=fsm-emitter'
    )
    r = _lint(src, path="fake/core/worker.py")
    assert _rules_hit(r) == {"fsm-emitter", BAD_SUPPRESSION}


# ---------------------------------------------------------------------------
# suppression machinery
# ---------------------------------------------------------------------------

def test_suppression_prose_after_comma_and_unknown_rule():
    # A reason whose first word follows the comma is prose, not a rule id.
    r = _lint("""
        import asyncio

        async def f():
            asyncio.create_task(g())  # graftlint: disable=bg-strong-ref, intentional best-effort probe
    """)
    assert not r.findings
    assert r.suppressions[0].rules == ("bg-strong-ref",)
    assert r.suppressions[0].reason == "intentional best-effort probe"
    # A misspelled rule id fails loud instead of silently suppressing nothing.
    r = _lint("""
        x = 1  # graftlint: disable=bg-strongref  typo in the rule id
    """)
    hits = [f for f in r.findings if f.rule == BAD_SUPPRESSION]
    assert len(hits) == 1 and "not a rule id" in hits[0].message


def test_multi_rule_suppression_with_spaces():
    r = _lint("""
        import asyncio
        import time

        async def f():
            time.sleep(asyncio.ensure_future(g()))  # graftlint: disable=no-blocking-in-async, bg-strong-ref  fixture exercising both rules at once
    """)
    assert not r.findings
    assert len(r.suppressions) == 1 and r.suppressions[0].rules == (
        "no-blocking-in-async",
        "bg-strong-ref",
    )
    assert r.suppressions[0].reason.startswith("fixture")


def test_bad_suppression_is_a_finding_even_with_nothing_to_suppress():
    r = _lint("""
        x = 1  # graftlint: disable=bg-strong-ref
    """)
    assert _rules_hit(r) == {BAD_SUPPRESSION}


def test_suppression_only_silences_named_rules():
    r = _lint("""
        import asyncio
        import time

        async def f():
            time.sleep(asyncio.create_task(g()))  # graftlint: disable=no-blocking-in-async  fixture: wrong-rule disable
    """)
    # The sleep is silenced; the create_task inside it is retained (call
    # argument), so the only signal left is... nothing. Now the inverse:
    r = _lint("""
        import asyncio

        async def f():
            asyncio.create_task(g())  # graftlint: disable=no-blocking-in-async  wrong rule named
    """)
    assert "bg-strong-ref" in _rules_hit(r)


def test_suppression_inside_string_literal_is_data_not_directive():
    r = _lint('''
        FIXTURE = """
        asyncio.create_task(g())  # graftlint: disable=bg-strong-ref
        """
        OTHER = "x  # graftlint: disable=counted-trims"
    ''')
    assert not r.findings and not r.suppressions


def test_suppression_on_closing_line_of_multiline_statement():
    """A disable comment where formatters put it — on the closing line of a
    multi-line call — still suppresses, and is counted as used."""
    r = _lint("""
        import asyncio

        async def f():
            asyncio.create_task(
                g()
            )  # graftlint: disable=bg-strong-ref  best-effort prefetch, droppable
    """)
    assert not r.findings and len(r.suppressions) == 1


def test_unused_suppression_is_a_finding():
    r = _lint("""
        x = compute()  # graftlint: disable=bg-strong-ref  was needed before the refactor
    """)
    hits = [f for f in r.findings if f.rule == UNUSED_SUPPRESSION]
    assert len(hits) == 1 and "stale" in hits[0].message
    assert not r.suppressions  # an unused disable is not part of the inventory


def test_syntax_error_is_reported_not_crashed():
    r = _lint("def broken(:\n")
    assert r.errors and not r.findings


# ---------------------------------------------------------------------------
# counted-sheds
# ---------------------------------------------------------------------------

def test_counted_sheds_fires_on_uncounted_deadline_raise():
    r = _lint("""
        def gate(ctx, now):
            if now >= ctx.deadline:
                raise DeadlineExceeded("expired at gate")
    """)
    hits = [f for f in r.findings if f.rule == "counted-sheds"]
    assert len(hits) == 1 and hits[0].line == 4


def test_counted_sheds_fires_on_uncounted_shed_function():
    r = _lint("""
        class Proxy:
            def _shed_response(self, klass):
                return ("429 Too Many Requests", b"{}", "application/json")
    """)
    hits = [f for f in r.findings if f.rule == "counted-sheds"]
    assert len(hits) == 1 and "shed path" in hits[0].message


def test_counted_sheds_quiet_when_counted():
    r = _lint("""
        class Proxy:
            def _shed_response(self, klass):
                self._shed_total.inc(tags={"class": klass})
                return ("429 Too Many Requests", b"{}", "application/json")

        def gate(ctx, now, stats):
            if now >= ctx.deadline:
                stats.expired_count += 1
                raise DeadlineExceeded("expired at gate")
    """)
    assert "counted-sheds" not in _rules_hit(r)


def test_counted_sheds_ignores_shed_substrings_and_other_raises():
    """"finished"/"watershed" contain "shed" as a substring but are not shed
    paths; raising other exception types is not a request drop."""
    r = _lint("""
        def on_finished(self):
            raise TimeoutError("not a qos drop")

        def watershed_model(x):
            return x
    """)
    assert "counted-sheds" not in _rules_hit(r)


def test_counted_sheds_suppressed_with_reason():
    r = _lint("""
        def gate(ctx, now):
            if now >= ctx.deadline:
                raise DeadlineExceeded("x")  # graftlint: disable=counted-sheds  caller tallies this drop
    """)
    assert "counted-sheds" not in _rules_hit(r)
    assert len(r.suppressions) == 1


def test_counted_sheds_suppressed_without_reason_still_fires():
    r = _lint("""
        def gate(ctx, now):
            if now >= ctx.deadline:
                raise DeadlineExceeded("x")  # graftlint: disable=counted-sheds
    """)
    assert "counted-sheds" in _rules_hit(r)
    assert BAD_SUPPRESSION in _rules_hit(r)


# ---------------------------------------------------------------------------
# counted-transfers
# ---------------------------------------------------------------------------

def test_counted_transfers_fires_on_uncounted_sendfile():
    r = _lint("""
        import os

        def serve(self, fd, pos, left):
            os.sendfile(self.sock.fileno(), fd, pos, left)
    """)
    hits = [f for f in r.findings if f.rule == "counted-transfers"]
    assert len(hits) == 1 and hits[0].line == 5


def test_counted_transfers_fires_on_uncounted_sendmsg():
    r = _lint("""
        def ship(self, bufs):
            sent = self.sock.sendmsg(bufs)
            return sent
    """)
    hits = [f for f in r.findings if f.rule == "counted-transfers"]
    assert len(hits) == 1 and "sendmsg" in hits[0].message


def test_counted_transfers_quiet_when_counted():
    r = _lint("""
        import os

        def serve(self, fd, pos, left):
            n = os.sendfile(self.sock.fileno(), fd, pos, left)
            self.bytes_out += n

        def ship(self, bufs, metrics):
            sent = self.sock.sendmsg(bufs)
            metrics.transfer_bytes.inc(sent)
    """)
    assert "counted-transfers" not in _rules_hit(r)


def test_counted_transfers_ignores_plain_send_and_names():
    """Bare socket.send/sendall and functions merely named sendfile are not
    kernel-assisted transfer syscalls tracked by this rule."""
    r = _lint("""
        def relay(self, data):
            self.sock.sendall(data)

        def sendfile(path):
            return path
    """)
    assert "counted-transfers" not in _rules_hit(r)


def test_counted_transfers_suppressed_with_reason():
    r = _lint("""
        def finish(self, mv):
            await_result = self.loop.sock_sendall(self.sock, mv)  # graftlint: disable=counted-transfers  caller counted the whole frame
            return await_result
    """)
    assert "counted-transfers" not in _rules_hit(r)
    assert len(r.suppressions) == 1


# ---------------------------------------------------------------------------
# the tier-1 gate: whole tree at zero, report written, CLI contract
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# chaos-gate
# ---------------------------------------------------------------------------

def test_chaos_gate_fires_on_dynamic_site_name():
    r = _lint("""
        from ray_tpu_torch import chaos

        def serve(name):
            chaos.maybe_inject(name)
            chaos.maybe_inject("prefix." + name)
            chaos.maybe_inject(f"site.{name}")
    """)
    assert [f.line for f in r.findings if f.rule == "chaos-gate"] == [5, 6, 7]


def test_chaos_gate_fires_on_duplicate_site_name():
    r = _lint("""
        from ray_tpu_torch import chaos as _chaos

        def a():
            _chaos.maybe_inject("node.thing")

        def b():
            _chaos.maybe_inject("node.thing")
    """)
    hits = [f for f in r.findings if f.rule == "chaos-gate"]
    assert len(hits) == 1 and hits[0].line == 8 and "duplicate" in hits[0].message


def test_chaos_gate_duplicate_detection_is_tree_wide(tmp_path):
    from ray_tpu_torch.analysis import lint_paths

    a = tmp_path / "a.py"
    b = tmp_path / "b.py"
    a.write_text("from ray_tpu_torch import chaos\n\n\ndef f():\n    chaos.maybe_inject('x.y')\n")
    b.write_text("from ray_tpu_torch import chaos\n\n\ndef g():\n    chaos.maybe_inject('x.y')\n")
    result = lint_paths([str(a), str(b)])
    hits = [f for f in result.findings if f.rule == "chaos-gate"]
    assert len(hits) == 1 and hits[0].path == str(b), hits


def test_chaos_gate_fires_on_adhoc_branching_and_internals():
    r = _lint("""
        from ray_tpu_torch import chaos

        def f():
            if chaos.active() is not None:   # ad-hoc chaos branch
                raise RuntimeError("my own fault")
            chaos._PLAN = None               # plan internals
    """)
    assert [f.line for f in r.findings if f.rule == "chaos-gate"] == [5, 7]


def test_chaos_gate_fires_on_internal_imports_outside_pkg():
    r = _lint("""
        from ray_tpu_torch.chaos import injection_log
        from ray_tpu_torch.chaos.plan import maybe_inject
    """)
    assert [f.line for f in r.findings if f.rule == "chaos-gate"] == [2, 3]


def test_chaos_gate_clean_on_sanctioned_idiom():
    r = _lint("""
        from ray_tpu_torch import chaos as _chaos

        def write_frame(self, data):
            fault = _chaos.maybe_inject("my.site", peer=self.peer)
            if fault is not None and fault.kind == "drop":
                return
            _chaos.install_from_json("{}")
            series = _chaos.metrics_series()
    """)
    assert "chaos-gate" not in _rules_hit(r)


def test_chaos_gate_exempts_the_chaos_package_itself():
    r = _lint("""
        from ray_tpu_torch.chaos import plan as _plan

        def runner():
            if _plan.active() is not None:
                pass
    """, path="ray_tpu_torch/chaos/scenarios.py")
    assert "chaos-gate" not in _rules_hit(r)


def test_chaos_gate_suppression_cases():
    fires = """
        from ray_tpu_torch import chaos

        def f(name):
            chaos.maybe_inject(name){}
    """
    r = _lint(fires.format("  # graftlint: disable=chaos-gate  fixture exercises dynamic names"))
    assert "chaos-gate" not in _rules_hit(r)
    r = _lint(fires.format("  # graftlint: disable=chaos-gate"))
    assert {"chaos-gate", BAD_SUPPRESSION} <= _rules_hit(r)


def test_chaos_site_catalog_matches_tree():
    """Every cataloged site has exactly one gate in the tree and every gate
    is cataloged — the catalog IS the schedule-validation ground truth."""
    from ray_tpu_torch.analysis import lint_paths
    from ray_tpu_torch.chaos.sites import SITES

    result = lint_paths([PKG_DIR])
    woven = set()
    for _path, stats in result.stats.items():
        woven.update(stats.get("chaos-gate", {}).get("sites", []))
    assert woven == set(SITES), (
        f"cataloged-but-unwoven: {sorted(set(SITES) - woven)}; "
        f"woven-but-uncataloged: {sorted(woven - set(SITES))}"
    )


def test_whole_tree_zero_findings():
    """The regression gate that keeps future PRs honest: every invariant
    violation in the shipped tree is either fixed or suppressed with a
    written reason. (LINT.json is written by test_aaa_lint_gate.py — the
    fail-fast gate that runs first — so the report has a single writer.)"""
    result = lint_paths([PKG_DIR])
    assert not result.errors, result.errors
    assert not result.findings, "\n" + "\n".join(f.render() for f in result.findings)
    # The scan is alive: it saw the tree's suppressions and the fsm emitters.
    assert result.files > 50
    worker_stats = next(
        (s["fsm-emitter"] for p, s in result.stats.items() if "fsm-emitter" in s), None
    )
    assert worker_stats and worker_stats["emitters"] >= 1


def test_overlapping_paths_lint_each_file_once(tmp_path):
    bad = tmp_path / "regress.py"
    bad.write_text("import asyncio\n\n\nasync def f():\n    asyncio.create_task(g())\n")
    result = lint_paths([str(bad), str(tmp_path)])
    assert result.files == 1
    assert len(result.findings) == 1


def test_nonexistent_path_is_an_error_not_a_green_gate(tmp_path):
    """`lint <typo>` must not exit 0 having linted zero files."""
    result = lint_paths([str(tmp_path / "no_such_dir")])
    assert result.errors and result.files == 0
    from ray_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["lint", str(tmp_path / "no_such_dir")])
    assert exc.value.code == 1


def test_cli_exits_nonzero_on_reintroduced_fire_and_forget(tmp_path):
    bad = tmp_path / "regress.py"
    bad.write_text(
        "import asyncio\n\n\nasync def f():\n    asyncio.create_task(g())\n"
    )
    from ray_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["lint", str(bad)])
    assert exc.value.code == 1
    with pytest.raises(SystemExit) as exc:
        main(["lint", os.path.join(PKG_DIR, "analysis")])
    assert exc.value.code == 0


def test_json_report_shape_is_stable(tmp_path):
    bad = tmp_path / "regress.py"
    bad.write_text("import asyncio\n\n\nasync def f():\n    asyncio.create_task(g())\n")
    result = lint_paths([str(bad)])
    report = result.to_json()
    assert report["version"] == 2
    # v2: every registered rule gets a rollup, firing or not.
    assert {"bg-strong-ref", "chaos-gate", "rpc-verb-contract",
            "metric-contract", "dtype-kind"} <= set(report["rules"])
    entry = report["rules"]["bg-strong-ref"]
    assert entry["findings"] == 1 and entry["suppressed"] == 0
    assert entry["sites"][0].startswith(str(bad) + ":5:")
    assert report["rules"]["chaos-gate"] == {
        "findings": 0, "suppressed": 0, "sites": []}
    assert "index" in report
