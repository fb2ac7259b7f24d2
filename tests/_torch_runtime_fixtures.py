"""Fixtures for the reference's runtime suites copied onto the port
(``tests/test_torch_<name>.py``): ``shared_ray`` and ``fresh_cluster`` as
the repo conftest defines them for ``ray_tpu``, on ``ray_tpu_torch``, and a
module-boundary leak sentinel for the port's ``api`` (the conftest's
sentinel watches only ``ray_tpu``). A copied suite imports all three by
name so that pytest registers them in its module::

    from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401

pytest orders a module's autouse fixtures of one scope by name, so the
sentinel's name sorts before a suite's own autouse session fixture
(``_session``, ``_cluster``): it is set up first and checks after that
fixture's teardown.
"""
import pytest


@pytest.fixture(scope="module")
def shared_ray():
    import ray_tpu_torch as rt

    rt.init(num_cpus=8)
    yield rt
    rt.shutdown()


@pytest.fixture
def fresh_cluster():
    from ray_tpu_torch.core.api import Cluster
    from ray_tpu_torch.core.config import get_config

    # Tests tune the cluster's knobs through cluster.config, which is the
    # port's process-global Config: snapshot and restore it.
    cfg = get_config()
    snap = cfg.to_dict()
    cluster = Cluster(initialize_head=False)
    yield cluster
    cluster.shutdown()
    for k, v in snap.items():
        setattr(cfg, k, v)


@pytest.fixture(autouse=True, scope="module")
def _aa_port_leak_sentinel(request):
    """A module that leaves a live port Cluster, an initialized port driver
    session, a session auth token or a drifted port Config behind fails
    here, at the leak's source, and is cleaned up."""
    from ray_tpu_torch.core import api, rpc
    from ray_tpu_torch.core.config import get_config

    before = list(api._LIVE_CLUSTERS)
    cfg_before = get_config().to_dict()
    yield
    leaks = []
    if api._global_worker is not None:
        leaks.append("port driver session left initialized (missing rt.shutdown())")
        try:
            api.shutdown()
        except Exception:
            pass
    for c in [c for c in list(api._LIVE_CLUSTERS) if c not in before]:
        leaks.append(f"port Cluster {getattr(c, 'controller_addr', '?')} left running")
        try:
            c.shutdown()
        except Exception:
            pass
    cfg = get_config()
    env_token = type(cfg)().apply_env().auth_token
    if cfg.auth_token and cfg.auth_token != env_token and not api._token_owned_by_live_cluster(cfg.auth_token):
        leaks.append(f"session auth token '{cfg.auth_token[:8]}…' leaked into the port's config")
        cfg.auth_token = env_token
        rpc.set_auth_token(env_token or None)
    drift = {
        k: (cfg_before[k], v) for k, v in get_config().to_dict().items()
        if k != "auth_token" and v != cfg_before[k]
    }
    if drift:
        leaks.append(f"the port's process-global Config drifted: {drift}")
        for k, v in cfg_before.items():
            if k != "auth_token":
                setattr(cfg, k, v)
    assert not leaks, f"{request.module.__name__} leaked cross-test state:\n  " + "\n  ".join(leaks)
