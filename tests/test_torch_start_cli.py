"""The port's `start`/`stop` CLI: ``tests/test_start_cli.py``'s 4 cases
through ``python -m ray_tpu_torch`` (the port's state dir is
``RAYTPU_TORCH_STATE_DIR``, its autodetect switch ``--no-gpu-autodetect``),
and one case of the port's own: a running ``ray_tpu`` head and a running
port head on one host, each package's `stop` leaving the other's daemon and
state dir untouched.

`ray_tpu_torch start` bootstrap: a REAL two-host-shaped cluster formed from two
separate OS processes — no `Cluster`, no shared Python state — then driven
purely via `--address` (reference: `ray start --head` / `--address`,
python/ray/scripts/scripts.py:682).

The head and the joining node are each `python -m ray_tpu_torch start` subprocesses
(the CLI's detached mode, exactly what an operator types on each pod host);
the driver is THIS process connecting by address. Token distribution rides
RAYTPU_AUTH_TOKEN, the multi-host path.
"""
import json
import os
import subprocess
import sys
import time

import pytest

TOKEN = "start-cli-test-token"


@pytest.fixture(autouse=True)
def _fresh_auth_state():
    """These tests assert properties of THIS test's session lifecycle
    (mint -> scrub). Under a sequential full-suite run, an EARLIER module's
    leaked state — an unscrubbed token in the process-global Config, a
    Cluster record left in _LIVE_CLUSTERS by a crashed teardown, a stale
    rpc frame key — made all three fail while each passes in isolation
    Force a clean slate on entry and exit instead of
    asserting the previous module behaved: prior-test hygiene is not what
    these tests are for, and a stale key would also make this module's
    driver MAC-fail every frame against its own freshly-tokened cluster
    (the observed connect timeout)."""
    from ray_tpu_torch.core import api, rpc
    from ray_tpu_torch.core.config import get_config

    def scrub():
        cfg = get_config()
        cfg.auth_token = type(cfg)().apply_env().auth_token
        rpc.set_auth_token(cfg.auth_token or None)
        # Drop dead Cluster records: a live cluster's service thread is
        # running; anything else only serves to make
        # _token_owned_by_live_cluster veto the stale-mint drop for a
        # session that no longer exists.
        api._LIVE_CLUSTERS[:] = [
            c for c in api._LIVE_CLUSTERS
            if getattr(getattr(c, "host", None), "thread", None) is not None
            and c.host.thread.is_alive()
        ]

    scrub()
    yield
    scrub()


def _cli(env, *args, timeout=300, package="ray_tpu_torch"):
    return subprocess.run(
        [sys.executable, "-m", package, *args],
        env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.fixture
def cli_cluster(tmp_path):
    env = dict(os.environ)
    env["RAYTPU_TORCH_STATE_DIR"] = str(tmp_path / "state")
    env["RAYTPU_AUTH_TOKEN"] = TOKEN
    addr_file = str(tmp_path / "head_addr")

    head = _cli(env, "start", "--head", "--port", "0", "--num-cpus", "4",
                "--no-gpu-autodetect", "--address-file", addr_file,
                "--startup-timeout", "240")
    assert head.returncode == 0, f"head start failed:\n{head.stdout}\n{head.stderr}"
    addr = open(addr_file).read().strip()

    join = _cli(env, "start", f"--address={addr}", "--num-cpus", "4",
                "--resources", '{"joiner": 1}', "--no-gpu-autodetect",
                "--startup-timeout", "240")
    assert join.returncode == 0, f"join failed:\n{join.stdout}\n{join.stderr}"

    yield addr, env

    stop = _cli(env, "stop")
    assert "stopped" in stop.stdout


def test_minted_token_scrubbed_on_shutdown():
    """Regression (an order-sensitive ConnectionLost): an in-process
    session auto-mints its RPC token into the process-global Config; shutdown
    must scrub it, or the next init(address=...) in the same process
    authenticates to a fresh cluster with the dead session's secret and every
    frame fails the MAC check."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.config import get_config

    assert not get_config().auth_token
    rt.init(num_cpus=1)
    try:
        assert get_config().auth_token, "in-process cluster should auto-mint"
    finally:
        rt.shutdown()
    assert not get_config().auth_token, "stale session token leaked into global config"


def test_stale_minted_token_dropped_on_head_init():
    """Defense in depth for the suite-scale leak, HEAD-init side: even if
    some teardown DID leave a dead session's auto-minted token in the
    global config (skipped scrub), a new in-process cluster must drop it
    and mint fresh. (The address-connect side of the same guard is
    exercised by test_start_cli_two_process_cluster, which deliberately
    seeds a stale mint before rt.init(address=...).)"""
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    assert not cfg.auth_token
    try:
        cfg.auth_token = "deadbeef" * 4
        api._MINTED_HISTORY.add(cfg.auth_token)  # simulate a leaked mint
        import ray_tpu_torch as rt

        rt.init(num_cpus=1)  # head init re-mints fresh (stale token dropped?)
        rt.shutdown()
        assert not get_config().auth_token
    finally:
        cfg.auth_token = ""


def test_start_cli_two_process_cluster(cli_cluster):
    addr, env = cli_cluster
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.config import get_config

    # The flake fired only when OTHER tests' sessions ran first in
    # this process: reproduce that deliberately with a throwaway in-process
    # session before connecting to the CLI-started cluster, AND with a
    # deliberately-leaked stale minted token (the suite-scale failure mode:
    # some earlier teardown skipped its scrub).
    rt.init(num_cpus=1)
    rt.shutdown()
    get_config().auth_token = "feedface" * 4
    api._MINTED_HISTORY.add(get_config().auth_token)

    rt.init(address=addr)  # must rediscover via the session token file
    try:
        # Both standalone daemons registered.
        deadline = time.time() + 60
        while time.time() < deadline:
            s = api._cluster_state()
            if sum(1 for n in s["nodes"].values() if n["state"] == "ALIVE") >= 2:
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"joiner never registered: {s['nodes']}")

        # Task — targeted at the joining process's node.
        @rt.remote(resources={"joiner": 1})
        def whoami():
            return rt.get_runtime_context().node_id

        @rt.remote
        def double(x):
            return 2 * x

        joiner_node = rt.get(whoami.remote(), timeout=120)
        assert rt.get(double.remote(21), timeout=120) == 42

        # Actor pinned to the joiner, surviving across calls.
        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        c = Counter.options(resources={"joiner": 0.5}).remote()
        assert [rt.get(c.inc.remote(), timeout=120) for _ in range(3)] == [1, 2, 3]

        # Placement group spanning both OS processes.
        pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
        assert pg.ready(timeout=120)
        nodes = set(pg.bundle_nodes())
        assert len(nodes) == 2 and joiner_node in nodes

        # Train gang across the two daemons.
        from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig
        from ray_tpu_torch import train

        def loop(config):
            ctx = train.get_context()
            for i in range(2):
                train.report({"step": i, "rank": ctx.get_world_rank()})

        trainer = DataParallelTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 2}),
            run_config=RunConfig(name="cli_gang"),
        )
        result = trainer.fit()
        assert result.error is None
        assert result.metrics["step"] == 1
    finally:
        rt.shutdown()


def test_stop_kills_recorded_processes(tmp_path):
    env = dict(os.environ)
    env["RAYTPU_TORCH_STATE_DIR"] = str(tmp_path / "state")
    env["RAYTPU_AUTH_TOKEN"] = TOKEN
    addr_file = str(tmp_path / "addr")
    head = _cli(env, "start", "--head", "--port", "0", "--num-cpus", "1",
                "--no-gpu-autodetect", "--address-file", addr_file)
    assert head.returncode == 0, head.stderr
    state_dir = tmp_path / "state"
    recs = [json.load(open(state_dir / f)) for f in os.listdir(state_dir)
            if f.startswith("proc-")]
    assert len(recs) == 1 and recs[0]["role"] == "head"
    pid = recs[0]["pid"]
    _cli(env, "stop")
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except OSError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(f"head pid {pid} still alive after stop")
    assert not [f for f in os.listdir(state_dir) if f.startswith("proc-")]


def _wait_dead(pid, timeout_s=15.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except OSError:
            return True
        time.sleep(0.1)
    return False


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def test_each_package_stops_only_its_own_daemons(tmp_path):
    """Both packages' default state dirs under one TMPDIR: the port's `stop`
    leaves a running ``ray_tpu`` head and its state dir alone, and the
    reference's `stop` leaves the port's head alone."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RAYTPU_STATE_DIR", "RAYTPU_TORCH_STATE_DIR")}
    env["TMPDIR"] = str(tmp_path)
    env["RAYTPU_AUTH_TOKEN"] = TOKEN
    ref = _cli(env, "start", "--head", "--port", "0", "--num-cpus", "1",
               "--no-tpu-autodetect", "--address-file", str(tmp_path / "ref_addr"),
               package="ray_tpu")
    assert ref.returncode == 0, ref.stderr
    port = _cli(env, "start", "--head", "--port", "0", "--num-cpus", "1",
                "--no-gpu-autodetect", "--address-file", str(tmp_path / "port_addr"))
    try:
        assert port.returncode == 0, port.stderr
        ref_dir = tmp_path / f"raytpu-cluster-{os.getuid()}"
        port_dir = tmp_path / f"raytpu-torch-cluster-{os.getuid()}"

        def recs(d):
            return {f: json.load(open(d / f)) for f in os.listdir(d) if f.startswith("proc-")}

        ref_recs, port_recs = recs(ref_dir), recs(port_dir)
        assert len(ref_recs) == 1 and len(port_recs) == 1
        ref_pid = next(iter(ref_recs.values()))["pid"]
        port_pid = next(iter(port_recs.values()))["pid"]

        out = _cli(env, "stop")
        assert "stopped 1 process" in out.stdout, out.stdout
        assert _wait_dead(port_pid), f"port head {port_pid} outlived the port's stop"
        assert _alive(ref_pid), "the port's stop signalled the ray_tpu head"
        assert recs(ref_dir) == ref_recs, "the port's stop touched ray_tpu's state dir"

        port2 = _cli(env, "start", "--head", "--port", "0", "--num-cpus", "1",
                     "--no-gpu-autodetect", "--address-file", str(tmp_path / "port_addr2"))
        assert port2.returncode == 0, port2.stderr
        port_recs = recs(port_dir)
        port_pid = next(iter(port_recs.values()))["pid"]
        out = _cli(env, "stop", package="ray_tpu")
        assert "stopped 1 process" in out.stdout, out.stdout
        assert _wait_dead(ref_pid), f"ray_tpu head {ref_pid} outlived its stop"
        assert _alive(port_pid), "ray_tpu's stop signalled the port's head"
        assert recs(port_dir) == port_recs, "ray_tpu's stop touched the port's state dir"
    finally:
        _cli(env, "stop")
        _cli(env, "stop", package="ray_tpu")
