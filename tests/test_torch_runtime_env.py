"""Runtime environments on the port: ``tests/test_runtime_env.py``'s 16
cases with ``ray_tpu`` -> ``ray_tpu_torch`` (the container case forwards
``CUDA_`` variables where the reference forwards ``JAX_``), then the port
held to ``ray_tpu``: the same package URI and spec hash for the same tree,
and the same container command apart from the worker module and the GPU
flags, which each engine gets in its own form."""
import os

import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, shared_ray  # noqa: F401


def test_env_vars_on_task(shared_ray):
    @rt.remote(runtime_env={"env_vars": {"MY_FLAG": "hello-42"}})
    def read_flag():
        return os.environ.get("MY_FLAG")

    assert rt.get(read_flag.remote(), timeout=120) == "hello-42"

    # A plain task must NOT see the env var (pool isolation by env hash).
    @rt.remote
    def read_plain():
        return os.environ.get("MY_FLAG")

    assert rt.get(read_plain.remote(), timeout=120) is None


def test_working_dir_ships_code_and_cwd(shared_ray, tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "helper_mod_xyz.py").write_text("VALUE = 1234\n")
    (proj / "data.txt").write_text("payload!")

    @rt.remote(runtime_env={"working_dir": str(proj)})
    def use_workdir():
        import helper_mod_xyz  # importable from the shipped dir

        with open("data.txt") as f:  # cwd == extracted working_dir
            return helper_mod_xyz.VALUE, f.read()

    value, data = rt.get(use_workdir.remote(), timeout=120)
    assert value == 1234 and data == "payload!"


def test_py_modules_on_actor(shared_ray, tmp_path):
    mod_dir = tmp_path / "libs"
    (mod_dir / "shipped_pkg_abc").mkdir(parents=True)
    (mod_dir / "shipped_pkg_abc" / "__init__.py").write_text("NAME = 'shipped'\n")

    @rt.remote(runtime_env={"py_modules": [str(mod_dir)]})
    class Uses:
        def get(self):
            import shipped_pkg_abc

            return shipped_pkg_abc.NAME

    a = Uses.remote()
    assert rt.get(a.get.remote(), timeout=120) == "shipped"
    rt.kill(a)


def test_unknown_key_rejected(shared_ray):
    @rt.remote(runtime_env={"docker_image": "x"})  # not a supported key
    def f():
        return 1

    with pytest.raises(ValueError, match="unsupported runtime_env"):
        f.remote()


def _write_pkg(root, name, version):
    """A minimal installable package exposing conflictlib.__version__."""
    import os

    pkg = os.path.join(str(root), f"{name}_v{version.replace('.', '_')}")
    os.makedirs(os.path.join(pkg, "conflictlib"), exist_ok=True)
    with open(os.path.join(pkg, "pyproject.toml"), "w") as f:
        f.write(
            "[build-system]\nrequires = []\nbuild-backend = 'setuptools.build_meta'\n"
            f"[project]\nname = 'conflictlib'\nversion = '{version}'\n"
        )
    with open(os.path.join(pkg, "conflictlib", "__init__.py"), "w") as f:
        f.write(f"__version__ = {version!r}\n")
    with open(os.path.join(pkg, "setup.py"), "w") as f:
        f.write(
            "from setuptools import setup\n"
            f"setup(name='conflictlib', version={version!r}, packages=['conflictlib'])\n"
        )
    return pkg


@pytest.mark.slow  # heavy battery; tier-1 budget
def test_pip_venv_isolation_and_cache(shared_ray, tmp_path):
    """Two actors with CONFLICTING package versions coexist on one cluster
    (each runs from its own cached venv — reference: _private/runtime_env/
    pip.py + uri_cache.py); a second use of the same env hits the venv cache
    (no rebuild)."""
    import glob
    import os

    import ray_tpu_torch as rt

    p1 = _write_pkg(tmp_path, "conflictlib", "1.0")
    p2 = _write_pkg(tmp_path, "conflictlib", "2.0")
    opts = ["--no-index", "--no-build-isolation"]  # zero-egress host

    @rt.remote
    class Probe:
        def version(self):
            import conflictlib

            return conflictlib.__version__

    a1 = Probe.options(runtime_env={"pip": [p1], "pip_install_options": opts}).remote()
    a2 = Probe.options(runtime_env={"pip": [p2], "pip_install_options": opts}).remote()
    # Concurrent: both alive at once, each seeing ITS version.
    v1 = rt.get(a1.version.remote(), timeout=300)
    v2 = rt.get(a2.version.remote(), timeout=300)
    assert (v1, v2) == ("1.0", "2.0")
    # Venvs were built once each, content-hash keyed.
    venv_dirs = glob.glob("/tmp/raytpu_*/runtime_envs/venvs/*")
    assert len({os.path.basename(d) for d in venv_dirs}) >= 2

    # Cache hit: a THIRD actor with the same env reuses the built venv (fast
    # path returns the existing python; no .tmp build dir appears).
    before = set(glob.glob("/tmp/raytpu_*/runtime_envs/venvs/*"))
    a3 = Probe.options(runtime_env={"pip": [p1], "pip_install_options": opts}).remote()
    assert rt.get(a3.version.remote(), timeout=300) == "1.0"
    after = set(glob.glob("/tmp/raytpu_*/runtime_envs/venvs/*"))
    assert after == before, "same env rebuilt instead of cache hit"
    for a in (a1, a2, a3):
        rt.kill(a)


# ---------------------------------------------------------------------------
# conda + container (reference: _private/runtime_env/conda.py, image_uri.py)
# ---------------------------------------------------------------------------

def _write_fake_conda(tmp_path):
    """A fake conda binary implementing the two subcommands the backend
    uses: `info --base` and `env create -y -p DIR -f FILE`. The created
    "env" is a dir whose bin/python symlinks this interpreter and which
    drops a marker module on the env's path — enough to prove the worker
    really ran on the env's interpreter."""
    import stat
    import sys

    base = tmp_path / "conda_base"
    (base / "envs" / "named-env" / "bin").mkdir(parents=True)
    named_py = base / "envs" / "named-env" / "bin" / "python"
    named_py.symlink_to(sys.executable)
    script = tmp_path / "conda"
    script.write_text(f"""#!/bin/bash
set -e
if [ "$1" == "info" ]; then echo "{base}"; exit 0; fi
if [ "$1" == "env" ] && [ "$2" == "create" ]; then
  # args: env create -y -p DIR -f FILE
  while [ $# -gt 0 ]; do
    case "$1" in
      -p) DIR="$2"; shift 2;;
      -f) FILE="$2"; shift 2;;
      *) shift;;
    esac
  done
  mkdir -p "$DIR/bin"
  ln -s "{sys.executable}" "$DIR/bin/python"
  cp "$FILE" "$DIR/env.yml"
  exit 0
fi
echo "unexpected conda invocation: $@" >&2; exit 2
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script, base


def test_conda_named_env_runs_worker(shared_ray, tmp_path, monkeypatch):
    script, base = _write_fake_conda(tmp_path)
    monkeypatch.setenv("RAYTPU_CONDA_EXE", str(script))

    @rt.remote(runtime_env={"conda": "named-env"})
    def which_python():
        import sys

        return sys.executable

    exe = rt.get(which_python.remote(), timeout=120)
    assert "named-env" in exe, exe


def test_conda_dict_env_created_once_and_cached(shared_ray, tmp_path, monkeypatch):
    import glob

    script, _ = _write_fake_conda(tmp_path)
    monkeypatch.setenv("RAYTPU_CONDA_EXE", str(script))
    env_spec = {"conda": {"name": "job-env", "channels": ["conda-forge"],
                          "dependencies": ["python=3.12", {"pip": ["left-pad==1.0"]}]}}

    @rt.remote(runtime_env=env_spec)
    def which_python():
        import sys

        return sys.executable

    exe = rt.get(which_python.remote(), timeout=120)
    assert "/conda/" in exe, exe
    env_dir = os.path.dirname(os.path.dirname(exe))
    # The environment.yml really reached conda (spec round-tripped).
    yml = open(os.path.join(env_dir, "env.yml")).read()
    assert "job-env" in yml and "conda-forge" in yml and "left-pad==1.0" in yml
    # Cache: a second task with the SAME spec reuses the env (no new dirs).
    before = set(glob.glob("/tmp/raytpu_*/runtime_envs/conda/*"))
    assert rt.get(rt.remote(lambda: 1).options(runtime_env=env_spec).remote(), timeout=120) == 1
    assert set(glob.glob("/tmp/raytpu_*/runtime_envs/conda/*")) == before


def test_conda_missing_binary_errors_cleanly(shared_ray, monkeypatch):
    monkeypatch.setenv("RAYTPU_CONDA_EXE", "/nonexistent/conda")
    monkeypatch.setenv("PATH", "/usr/bin:/bin")  # no real conda either

    @rt.remote(runtime_env={"conda": "whatever"})
    def f():
        return 1

    with pytest.raises(Exception, match="conda"):
        rt.get(f.remote(), timeout=120)


def test_conda_and_pip_rejected(shared_ray):
    @rt.remote(runtime_env={"conda": "x", "pip": ["y"]})
    def f():
        return 1

    with pytest.raises(ValueError, match="conda"):
        f.remote()


def test_container_with_pip_or_conda_rejected(shared_ray):
    """The worker runs the image's interpreter; a host-built venv/conda env
    would be silently ignored — reject the combination up front."""
    for extra in ({"pip": ["x"]}, {"conda": "y"}):
        @rt.remote(runtime_env={"container": {"image": "img"}, **extra})
        def f():
            return 1

        with pytest.raises(ValueError, match="container"):
            f.remote()


def test_conda_unknown_named_env_fails_fast(shared_ray, tmp_path, monkeypatch):
    """A typo'd env NAME (conda exists, env doesn't) is permanent: the task
    fails with the creation error instead of the lease retrying forever."""
    import time

    script, _ = _write_fake_conda(tmp_path)
    monkeypatch.setenv("RAYTPU_CONDA_EXE", str(script))

    @rt.remote(runtime_env={"conda": "no-such-env"})
    def f():
        return 1

    t0 = time.monotonic()
    with pytest.raises(Exception, match="no-such-env"):
        rt.get(f.remote(), timeout=120)
    assert time.monotonic() - t0 < 60, "lease retried instead of failing fast"


def test_container_command_construction():
    from ray_tpu_torch.core.runtime_env import container_spawn_command

    env = {"RAYTPU_WORKER_ID": "w1", "PYTHONPATH": "/repo", "HOME": "/root",
           "CUDA_VISIBLE_DEVICES": "0", "JAX_PLATFORMS": "cpu", "SECRET_TOKEN": "nope"}
    cmd = container_spawn_command(
        {"image": "img:latest", "run_options": ["--cpus", "2"]},
        "/usr/bin/podman", env, "/sess", "/repo",
    )
    assert cmd[:3] == ["/usr/bin/podman", "run", "--rm"]
    assert "--network=host" in cmd and "--ipc=host" in cmd
    assert "-v" in cmd and "/sess:/sess" in cmd and "/repo:/repo" in cmd
    # Control-plane env forwarded; arbitrary host env NOT leaked.
    assert "RAYTPU_WORKER_ID=w1" in cmd and "CUDA_VISIBLE_DEVICES=0" in cmd
    assert not any("SECRET_TOKEN" in c or "HOME=" in c or "JAX_" in c for c in cmd)
    # run_options precede the image; worker command trails it.
    assert cmd.index("--cpus") < cmd.index("img:latest")
    assert cmd[-3:] == ["img:latest", "python", "-m"] or cmd[-4:] == [
        "img:latest", "python", "-m", "ray_tpu_torch.core.worker_main"]
    # podman reaches the cards through CDI.
    i = cmd.index("nvidia.com/gpu=all")
    assert cmd[i - 1] == "--device" and i < cmd.index("img:latest")


def test_auth_token_value_never_on_container_argv():
    """The session MAC secret must not be readable via /proc/<pid>/cmdline:
    RAYTPU_AUTH_TOKEN is forwarded as a VALUE-LESS `--env K` flag (engine
    inherits the value from the client env Popen receives), never `K=V`."""
    from ray_tpu_torch.core.runtime_env import container_spawn_command

    secret = "deadbeefcafef00d" * 2
    env = {"RAYTPU_AUTH_TOKEN": secret, "RAYTPU_WORKER_ID": "w1",
           "RAYTPU_CONTROLLER_ADDR": "127.0.0.1:1"}
    cmd = container_spawn_command(
        {"image": "img:latest"}, "/usr/bin/podman", env, "/sess", "/repo",
    )
    assert not any(secret in c for c in cmd), f"token value leaked into argv: {cmd}"
    # The variable is still forwarded — by name only.
    i = cmd.index("RAYTPU_AUTH_TOKEN")
    assert cmd[i - 1] == "--env"
    # Non-secret control-plane vars keep the explicit K=V form.
    assert "RAYTPU_WORKER_ID=w1" in cmd


def test_container_fake_engine_end_to_end(shared_ray, tmp_path, monkeypatch):
    """Behind the seam: a fake engine script that applies the --env args and
    execs the command after the image name — the worker runs as a plain
    subprocess, proving the command construction + env threading without
    podman/docker on the host."""
    import stat

    engine = tmp_path / "fake-engine"
    engine.write_text("""#!/bin/bash
envs=()
args=("$@")
i=0
n=${#args[@]}
while [ $i -lt $n ]; do
  a="${args[$i]}"
  if [ "$a" == "--env" ]; then
    i=$((i+1)); e="${args[$i]}"
    case "$e" in
      *=*) envs+=("$e");;
      # Value-less --env K: inherit from the engine client's own env —
      # podman/docker semantics; how secrets (RAYTPU_AUTH_TOKEN) arrive.
      *) envs+=("$e=${!e}");;
    esac
  elif [ "$a" == "test-image:v1" ]; then i=$((i+1)); break; fi
  i=$((i+1))
done
export RAYTPU_IN_FAKE_CONTAINER=1
exec env "${envs[@]}" RAYTPU_IN_FAKE_CONTAINER=1 "${args[@]:$i}"
""")
    engine.chmod(engine.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("RAYTPU_CONTAINER_ENGINE", str(engine))

    @rt.remote(runtime_env={"container": {"image": "test-image:v1"}})
    def probe():
        import os

        return os.environ.get("RAYTPU_IN_FAKE_CONTAINER"), os.environ.get("RAYTPU_WORKER_ID") is not None

    in_container, has_worker_id = rt.get(probe.remote(), timeout=120)
    assert in_container == "1"
    assert has_worker_id


def test_container_missing_engine_errors_cleanly(shared_ray, monkeypatch):
    monkeypatch.delenv("RAYTPU_CONTAINER_ENGINE", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")

    @rt.remote(runtime_env={"container": {"image": "img"}})
    def f():
        return 1

    with pytest.raises(Exception, match="podman nor docker"):
        rt.get(f.remote(), timeout=120)


def test_container_bad_spec_rejected(shared_ray):
    @rt.remote(runtime_env={"container": "not-a-dict"})
    def f():
        return 1

    with pytest.raises(ValueError, match="container"):
        f.remote()


# ---------------------------------------------------------------------------
# the port held to ray_tpu, and the container's GPU seam
# ---------------------------------------------------------------------------

class _KVCore:
    """The two things ``package_runtime_env`` uses of a driver: ``_run`` and
    ``controller.call("kv_put", ...)``; it records the uploads."""

    def __init__(self):
        self.puts = {}
        core = self

        class _Ctl:
            async def call(self, method, payload):
                assert method == "kv_put"
                core.puts[payload["key"]] = payload["value"]

        self.controller = _Ctl()

    def _run(self, coro):
        import asyncio

        return asyncio.run(coro)


def _tree(root):
    (root / "pkg" / "sub").mkdir(parents=True)
    (root / "pkg" / "__init__.py").write_text("X = 1\n")
    (root / "pkg" / "sub" / "data.bin").write_bytes(bytes(range(256)) * 7)
    (root / "pkg" / "__pycache__").mkdir()
    (root / "pkg" / "__pycache__" / "skip.pyc").write_bytes(b"never shipped")
    (root / "run.sh").write_text("#!/bin/sh\necho hi\n")
    os.chmod(root / "run.sh", 0o755)
    return root


def test_package_uris_and_hash_match_ray_tpu(tmp_path):
    from ray_tpu.core import runtime_env as ref
    from ray_tpu_torch.core import runtime_env as port

    wd = _tree(tmp_path / "wd")
    mods = _tree(tmp_path / "mods")
    (mods / "extra.py").write_text("Y = 2\n")
    renv = {"working_dir": str(wd), "py_modules": [str(mods)],
            "env_vars": {"A": "1"}, "pip": [str(mods), "left-pad==1.0"],
            "pip_install_options": ["--no-index"]}
    assert port._zip_dir(str(wd)) == ref._zip_dir(str(wd))
    c_ref, c_port = _KVCore(), _KVCore()
    s_ref = ref.package_runtime_env(c_ref, dict(renv))
    s_port = port.package_runtime_env(c_port, dict(renv))
    assert s_port == s_ref
    assert c_port.puts == c_ref.puts and len(c_port.puts) == 2
    assert port.MAX_PKG_BYTES == ref.MAX_PKG_BYTES and port.PKG_NS == ref.PKG_NS


def _cmd_pair(engine, env, **kw):
    from ray_tpu.core.runtime_env import container_spawn_command as ref_cmd
    from ray_tpu_torch.core.runtime_env import container_spawn_command as port_cmd

    spec = {"image": "img:v1", "run_options": ["--cpus", "2"]}
    return (ref_cmd(spec, engine, env, "/sess", "/repo", cwd="/sess/wd"),
            port_cmd(spec, engine, env, "/sess", "/repo", cwd="/sess/wd", **kw))


@pytest.mark.parametrize("engine,flags", [
    ("/usr/bin/podman", ["--device", "nvidia.com/gpu=all"]),
    ("/usr/local/bin/docker", ["--gpus", "all"]),
])
def test_container_command_matches_ray_tpu_but_for_gpu_flags(engine, flags):
    env = {"RAYTPU_WORKER_ID": "w1", "RAYTPU_AUTH_TOKEN": "s3cret", "PYTHONPATH": "/repo"}
    ref, port = _cmd_pair(engine, env)
    i = port.index(flags[0])
    assert port[i:i + 2] == flags
    stripped = port[:i] + port[i + 2:]
    assert stripped[:-1] == ref[:-1]
    assert (ref[-1], stripped[-1]) == ("ray_tpu.core.worker_main", "ray_tpu_torch.core.worker_main")
    # A node without a GPU gets the reference's command but for the module.
    _, plain = _cmd_pair(engine, env, gpus=False)
    assert plain[:-1] == ref[:-1]


def test_container_forwards_cuda_not_jax_variables():
    env = {"CUDA_VISIBLE_DEVICES": "1", "NVIDIA_VISIBLE_DEVICES": "all",
           "TORCH_CUDA_ARCH_LIST": "9.0a", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--x", "TPU_NAME": "t", "LD_PRELOAD": "/evil.so"}
    _, port = _cmd_pair("/usr/bin/podman", env)
    for k in ("CUDA_VISIBLE_DEVICES=1", "NVIDIA_VISIBLE_DEVICES=all", "TORCH_CUDA_ARCH_LIST=9.0a"):
        assert port[port.index(k) - 1] == "--env"
    assert not any(c.startswith(("JAX_", "XLA_", "TPU_", "LD_")) for c in port)
