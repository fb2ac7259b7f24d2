"""Dashboard: HTTP JSON API + Prometheus exposition for cluster state.

Role-equivalent to the reference's dashboard head (dashboard/head.py:49 and
its JSON module routes) minus the React frontend (an explicit non-goal,
SURVEY §7): the same information is served as JSON plus a minimal HTML
summary page, and /metrics serves the aggregated ray.util.metrics pipeline
in Prometheus format for external scrapers.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_INDEX = """<!doctype html><title>ray_tpu_torch dashboard</title>
<style>
body{font-family:system-ui,sans-serif;margin:2em;max-width:70em}
table{border-collapse:collapse;margin:0.6em 0}
td,th{border:1px solid #ccc;padding:0.25em 0.7em;text-align:left;font-size:0.92em}
h3{margin-bottom:0.1em}.muted{color:#777;font-size:0.85em}
</style>
<h2>ray_tpu_torch cluster</h2>
<div class=muted>auto-refreshes every 3s —
<a href=/api/cluster>cluster</a> · <a href=/api/tasks>tasks</a> ·
<a href=/api/actors>actors</a> · <a href=/api/objects>objects</a> ·
<a href=/api/summary>summary</a> · <a href=/api/memory>memory</a> ·
<a href=/api/events>events</a> · <a href=/api/checkpoints>checkpoints</a> ·
<a href=/api/serve>serve</a> ·
<a href=/api/metrics>metrics</a> · <a href=/api/traces>traces</a> ·
<a href=/api/slo>slo</a> · <a href=/api/autopsy>autopsy</a> ·
<a href=/api/flight>flight&nbsp;dumps</a> ·
<a href=/api/jobs>jobs</a> · <a href=/metrics>prometheus</a> ·
task filters: <code>/api/tasks?state=RUNNING&fn=NAME&node=ID&limit=50</code> ·
cluster flamegraph: <code>/api/profile</code>
(<code>?fmt=collapsed</code>, <code>?summary=1</code>, <code>?incidents=1</code>,
<code>?trace=TRACE_ID</code>, <code>?seconds=N</code>) ·
trace search: <code>/api/traces?q=NAME</code>, one trace: <code>/api/traces?id=TRACE_ID</code> ·
critical path: <code>/api/traces?id=TRACE_ID&autopsy=1</code></div>
<h3>Nodes</h3><table id=nodes></table>
<h3>Actors</h3><table id=actors></table>
<h3>Placement groups</h3><table id=pgs></table>
<script>
function row(cells, tag){return '<tr>'+cells.map(c=>'<'+tag+'>'+c+'</'+tag+'>').join('')+'</tr>'}
async function refresh(){
  try{
    const s = await (await fetch('/api/cluster')).json();
    const nodes = s.nodes||{};
    document.getElementById('nodes').innerHTML =
      row(['node','state','resources (avail/total)','labels'],'th') +
      Object.entries(nodes).map(([id,n])=>row([id.slice(0,12),
        n.state + (n.draining?' (draining)':''),
        Object.keys(n.resources_total||{}).map(k=>k+': '+(n.resources_available[k]??0)+'/'+n.resources_total[k]).join('<br>'),
        Object.entries(n.labels||{}).map(([k,v])=>k+'='+v).join('<br>')],'td')).join('');
    const actors = s.actors||{};
    document.getElementById('actors').innerHTML =
      row(['actor','name','state','node','worker addr'],'th') +
      Object.entries(actors).map(([id,a])=>row([id.slice(0,12), a.name||'',
        a.state, (a.node_id||'').slice(0,12), a.worker_addr||''],'td')).join('');
    const pgs = s.placement_groups||{};
    document.getElementById('pgs').innerHTML =
      row(['pg','state','bundles'],'th') +
      Object.entries(pgs).map(([id,p])=>row([id.slice(0,12), p.state,
        (p.bundles||[]).length],'td')).join('');
  }catch(e){}
}
refresh(); setInterval(refresh, 3000);
</script>"""


def _payload(path: str):
    from ray_tpu_torch.core import api

    core = api._require_worker()
    if path.startswith("/api/profile"):
        # Continuous-profiling plane. Default: merged cluster flamegraph
        # from every process's always-on sampler ring (last ?window=S
        # seconds, default 60). ?seconds=N runs a fresh blocking capture,
        # ?trace=ID fetches one request's per-trace fold, ?summary=1 the
        # sampler status rollup, ?incidents=1 the alert-triggered captures.
        # ?fmt=collapsed renders flamegraph.pl collapsed-stack text,
        # ?fmt=tree a d3-flame-graph JSON tree. Legacy per-worker py-spy
        # style capture stays on ?addr=IP:PORT&duration=2.
        from urllib.parse import parse_qs, urlsplit

        from ray_tpu_torch import obs as _obs
        from ray_tpu_torch.obs import profiler as _profiler

        q = {k: v[0] for k, v in parse_qs(urlsplit(path).query).items()}
        if q.get("addr"):
            return api.profile_worker(q["addr"], float(q.get("duration", 2.0)))
        if q.get("summary") not in (None, "", "0"):
            return _obs.profile_status()
        if q.get("incidents") not in (None, "", "0"):
            return _obs.profile_incidents()
        fold = _obs.profile_cluster(
            window_s=float(q.get("window", 60.0)),
            seconds=float(q["seconds"]) if q.get("seconds") else None,
            trace_id=q.get("trace", ""),
            node_id=q.get("node", ""),
            max_stacks=int(q.get("max_stacks", 0)),
        )
        fmt = q.get("fmt", "")
        if fmt == "collapsed":
            return (_profiler.to_collapsed(fold), "text/plain")
        if fmt == "tree":
            return _profiler.to_tree(fold)
        return fold
    if path.startswith(("/api/tasks", "/api/actors", "/api/objects", "/api/summary")):
        # State API passthrough (reference: dashboard state-api routes).
        # Filters ride the query string: ?state=RUNNING&node=..&fn=..&job=..
        # &limit=..; /api/tasks?id=<task_id> fetches one task's attempts.
        from urllib.parse import parse_qs, urlsplit

        from ray_tpu_torch import state as _state

        u = urlsplit(path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        limit = int(q.get("limit", 100))
        if u.path == "/api/tasks":
            if q.get("id"):
                return _state.get_task(q["id"])
            return _state.list_tasks(state=q.get("state"), node=q.get("node"),
                                     fn=q.get("fn"), job=q.get("job"), limit=limit)
        if u.path == "/api/actors":
            return _state.list_actors(state=q.get("state"), node=q.get("node"),
                                      name=q.get("name"), job=q.get("job"), limit=limit)
        if u.path == "/api/objects":
            return _state.list_objects(node=q.get("node"), limit=limit)
        if u.path == "/api/summary":
            return _state.summary_tasks(job=q.get("job"))
    if path.startswith("/api/checkpoints"):
        # Checkpoint-plane registry (ckpt manifests + publication channels):
        # ?channel=NAME&status=committed|aborted&limit=N
        from urllib.parse import parse_qs, urlsplit

        from ray_tpu_torch import state as _state

        q = {k: v[0] for k, v in parse_qs(urlsplit(path).query).items()}
        return _state.list_checkpoints(channel=q.get("channel"),
                                       status=q.get("status"),
                                       limit=int(q.get("limit", 100)))
    if path == "/api/memory":
        from ray_tpu_torch import state as _state

        return _state.memory_summary()
    if path == "/api/cluster":
        return core._run(core.controller.call("get_cluster_state", {}))
    if path.startswith("/api/events"):
        return core._run(core.controller.call("get_events", {"limit": 1000, "with_stats": True}))
    if path.startswith("/api/traces"):
        # Recent traces; ?id=<trace_id> fetches one trace's events,
        # ?q=<substr> filters by id prefix / root-span name,
        # ?id=<trace_id>&autopsy=1 decomposes the request's critical path.
        from urllib.parse import parse_qs, urlsplit

        q = parse_qs(urlsplit(path).query)
        trace_id = (q.get("id") or [""])[0]
        if trace_id:
            if (q.get("autopsy") or ["0"])[0] not in ("", "0"):
                return core._run(core.controller.call(
                    "trace_autopsy", {"trace_id": trace_id}))
            return core._run(core.controller.call("get_trace", {"trace_id": trace_id}))
        return core._run(core.controller.call(
            "list_traces",
            {"limit": int((q.get("limit") or ["100"])[0]), "q": (q.get("q") or [""])[0]},
        ))
    if path.startswith("/api/autopsy"):
        # Per-deployment "where does p99 go" hop aggregation (obs/autopsy).
        return core._run(core.controller.call("autopsy_summary", {}))
    if path.startswith("/api/slo"):
        # SLO burn-rate engine: objective status rows + the one-line rollup.
        # ?history=1 adds each objective's bounded burn trajectory ring.
        from urllib.parse import parse_qs, urlsplit

        q = parse_qs(urlsplit(path).query)
        out = {
            "summary": core._run(core.controller.call("slo_summary", {})),
            "objectives": core._run(core.controller.call("slo_status", {})),
        }
        if (q.get("history") or ["0"])[0] not in ("", "0"):
            out["history"] = core._run(core.controller.call("slo_history", {}))
        return out
    if path.startswith("/api/flight"):
        # Black-box dump registry: where every post-mortem file landed.
        return core._run(core.controller.call("list_flight_dumps", {"limit": 50}))
    if path == "/api/serve":
        # Scale-plane view: per-deployment replica sets, demand estimates,
        # and the autoscaler's decision log (serve/controller.py
        # get_serve_state).
        import ray_tpu_torch as rt
        from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE

        try:
            ctl = rt.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        except ValueError:
            return {"error": "serve controller not running", "apps": {}}
        return rt.get(ctl.get_serve_state.remote(), timeout=10)
    if path == "/api/metrics":
        return core._run(core.controller.call("get_metrics", {}))
    if path == "/api/jobs":
        from ray_tpu_torch.job import JobSubmissionClient

        return JobSubmissionClient().list_jobs()
    return None


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # silence request logging
        pass

    def do_GET(self):
        try:
            if self.path == "/" or self.path == "/index.html":
                body, ctype = _INDEX.encode(), "text/html"
            elif self.path == "/metrics":
                from ray_tpu_torch.core import api
                from ray_tpu_torch.util.metrics import prometheus_text

                core = api._require_worker()
                series = core._run(core.controller.call("get_metrics", {}))
                body, ctype = prometheus_text(series).encode(), "text/plain; version=0.0.4"
            else:
                data = _payload(self.path)
                if data is None:
                    self.send_error(404)
                    return
                if isinstance(data, tuple):  # pre-rendered (text, ctype)
                    body, ctype = data[0].encode(), data[1]
                else:
                    body, ctype = json.dumps(data, default=str).encode(), "application/json"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception as e:  # pragma: no cover — defensive
            try:
                self.send_error(500, str(e))
            except Exception:
                pass


_server: Optional[ThreadingHTTPServer] = None


def start_dashboard(port: int = 0, host: str = "127.0.0.1") -> int:
    """Start the dashboard HTTP server (idempotent); returns the port."""
    global _server
    if _server is not None:
        return _server.server_address[1]
    _server = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=_server.serve_forever, name="raytpu-dashboard", daemon=True).start()
    return _server.server_address[1]


def stop_dashboard():
    global _server
    if _server is not None:
        _server.shutdown()
        _server = None
