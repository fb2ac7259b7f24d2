"""Runtime environments: per-task/actor env_vars, working_dir, py_modules.

Role-equivalent to the reference's runtime_env plugin system
(python/ray/_private/runtime_env/: working_dir/py_modules
packaging with URI caching, per-node runtime-env agent materialization,
worker-pool keying by runtime-env hash — worker_pool.h:281). Redesign:
packages are content-addressed zips in the controller KV (the GCS KV plays
the package store, like the reference's GCS-backed working_dir uploads);
the node daemon materializes them into a per-URI cache directory and spawns
workers with the env vars / cwd / sys.path the spec demands. Idle workers
are pooled per runtime-env hash so a lease never reuses a worker built for
a different environment.

Supported keys: ``env_vars`` (dict), ``working_dir`` (local dir, shipped and
made the worker's cwd + sys.path entry), ``py_modules`` (list of local dirs
added to sys.path), ``pip`` (list of requirement strings — the daemon builds
a cached ``--system-site-packages`` venv keyed by the requirement set and
spawns the worker from that venv's interpreter, so two jobs with conflicting
dependency versions coexist on one cluster; reference:
_private/runtime_env/pip.py + uri_cache.py), ``pip_install_options`` (extra
pip args, e.g. ``--no-index`` for air-gapped local-path installs),
``conda`` (a NAMED existing conda env, or a dict of environment.yml content
the daemon creates once per content hash — the worker then runs on that
env's hermetic interpreter; reference: _private/runtime_env/conda.py),
``container`` ({"image": ..., "run_options": [...]}: the worker process
launches inside a podman/docker container wrapping the worker command with
the engine invocation — host networking + /dev/shm so the RPC plane and the
shared-memory object store still reach it; reference:
_private/runtime_env/image_uri.py). The container is given the node's GPUs
(``--device nvidia.com/gpu=all`` for podman through CDI, ``--gpus all`` for
docker) and the worker's ``CUDA_``/``NVIDIA_``/``TORCH_`` variables, so a
GPU task inside it sees the same cards as one outside. Conda and container need their binaries
on the NODE: discovery honors ``RAYTPU_CONDA_EXE`` / ``RAYTPU_CONTAINER_ENGINE``
overrides (also the test seam), then falls back to PATH lookup, and raises a
clear per-lease error when absent.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any

PKG_NS = "runtime_env_pkg"
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
MAX_PKG_BYTES = 256 * 1024 * 1024


class RuntimeEnvSetupError(RuntimeError):
    """A DETERMINISTIC runtime-env materialization failure: the same spec
    will fail identically on every retry (missing conda/container binary,
    failed pip/conda env build, package absent from the cluster KV, invalid
    spec). Submitters treat it as PERMANENT for the task's scheduling key
    and fail the queued tasks instead of retrying the lease forever.

    Transient faults (a kv_get RPC hiccup mid-download, a controller
    restart) must NOT be raised as this type — they propagate as-is and the
    lease request retries. Picklable with its message, so the distinction
    survives the daemon->submitter RPC hop (worker.py checks isinstance,
    not message substrings).
    """


def _zip_dir(path: str) -> bytes:
    """Deterministic zip: sorted walk order + fixed timestamps, so identical
    directory CONTENTS always produce identical bytes (the content-addressed
    URI and env hash must not vary with mtimes or filesystem order)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env path {path!r} is not a directory")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            for f in sorted(files):
                full = os.path.join(root, f)
                info = zipfile.ZipInfo(os.path.relpath(full, path), date_time=(1980, 1, 1, 0, 0, 0))
                info.compress_type = zipfile.ZIP_DEFLATED
                info.external_attr = (os.stat(full).st_mode & 0o777) << 16
                with open(full, "rb") as src:
                    z.writestr(info, src.read())
    data = buf.getvalue()
    if len(data) > MAX_PKG_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes zipped "
            f"(max {MAX_PKG_BYTES}); ship big data via the object store instead"
        )
    return data


def package_runtime_env(core, renv: dict) -> dict:
    """Resolve a user runtime_env into a shippable spec: local dirs become
    content-addressed packages in the controller KV (uploaded once per
    content hash — the reference's URI cache), env_vars pass through."""
    if renv.get("_resolved"):
        return renv  # already packaged (e.g. reused from another task's options)
    known = {"env_vars", "working_dir", "py_modules", "pip", "pip_install_options",
             "conda", "container"}
    unknown = set(renv) - known
    if unknown:
        raise ValueError(f"unsupported runtime_env keys {sorted(unknown)}; supported: {sorted(known)}")
    if renv.get("conda") is not None and renv.get("pip"):
        # Both resolve to "which interpreter runs the worker" — ambiguous.
        # (The reference nests pip inside the conda env spec instead; here:
        # put pip deps in the conda dict's dependencies.)
        raise ValueError("runtime_env cannot set both 'conda' and 'pip'; "
                         "add pip deps inside the conda environment dict")
    if renv.get("conda") is not None and not isinstance(renv["conda"], (str, dict)):
        raise ValueError("runtime_env 'conda' must be an env NAME (str) or an "
                         "environment.yml dict")
    if renv.get("container") is not None:
        c = renv["container"]
        if not isinstance(c, dict) or not isinstance(c.get("image"), str) or not c["image"]:
            raise ValueError("runtime_env 'container' must be a dict with an 'image' str")
        if renv.get("pip") or renv.get("conda") is not None:
            # The worker runs the IMAGE's interpreter; a host-built venv or
            # conda env would be silently ignored inside it.
            raise ValueError("runtime_env 'container' cannot combine with "
                             "'pip'/'conda' — bake dependencies into the image")
    cache = getattr(core, "_renv_pkg_cache", None)
    if cache is None:
        cache = core._renv_pkg_cache = {}

    def upload(path: str) -> str:
        path = os.path.abspath(path)
        uri = cache.get(path)
        if uri is not None:
            return uri
        data = _zip_dir(path)
        uri = "pkg-" + hashlib.sha1(data).hexdigest()
        core._run(
            core.controller.call(
                "kv_put", {"ns": PKG_NS, "key": uri, "value": data, "overwrite": False}
            )
        )
        cache[path] = uri
        return uri

    spec: dict[str, Any] = {"_resolved": True, "env_vars": dict(renv.get("env_vars", {}))}
    pkgs = []
    if renv.get("working_dir"):
        pkgs.append({"uri": upload(renv["working_dir"]), "kind": "working_dir"})
    for mod in renv.get("py_modules", []):
        pkgs.append({"uri": upload(mod), "kind": "py_module"})
    spec["pkgs"] = pkgs
    if renv.get("pip"):
        reqs = renv["pip"]
        if isinstance(reqs, dict):
            reqs = reqs.get("packages", [])
        # Local-path requirements become content-addressed packages too: the
        # venv key must change when the source changes, and remote daemons
        # need the bits (the reference ships working-dir-relative pips the
        # same way).
        resolved = []
        for r in reqs:
            if os.path.isdir(r):
                resolved.append({"uri": upload(r), "kind": "pip_local"})
            else:
                resolved.append({"req": str(r)})
        spec["pip"] = resolved
        spec["pip_install_options"] = list(renv.get("pip_install_options", []))
    if renv.get("conda") is not None:
        spec["conda"] = renv["conda"]
    if renv.get("container") is not None:
        spec["container"] = {
            "image": renv["container"]["image"],
            "run_options": list(renv["container"].get("run_options", [])),
        }
    spec["hash"] = hashlib.sha1(
        json.dumps(
            {k: spec.get(k) for k in (
                "env_vars", "pkgs", "pip", "pip_install_options", "conda", "container",
            )},
            sort_keys=True,
        ).encode()
    ).hexdigest()[:16]
    return spec


async def _fetch_pkg(uri: str, cache_root: str, kv_get) -> str:
    """Download/extract one content-addressed package (cached per URI);
    returns the extracted directory."""
    import asyncio

    dest = os.path.join(cache_root, uri)
    if not os.path.isdir(dest):
        data = await kv_get(uri)
        if data is None:
            raise RuntimeEnvSetupError(f"runtime_env package {uri} missing from the cluster KV")

        def extract():  # off the event loop: large zips must not stall the daemon
            tmp = f"{dest}.tmp{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(data)) as z:
                z.extractall(tmp)
            try:
                os.rename(tmp, dest)
            except OSError:  # concurrent materialization won the race
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)

        await asyncio.get_running_loop().run_in_executor(None, extract)
    return dest


# Per-venv-key build locks: concurrent leases on one event loop (e.g. the
# in-process test cluster's daemons) build each venv exactly once
# (reference: pip.py builds under a per-URI lock). Cross-process safety
# comes from unique tmp dirs + the atomic rename.
_venv_locks: dict[str, Any] = {}


async def _build_venv(spec: dict, cache_root: str, kv_get) -> str:
    """Build (or reuse) the venv for a pip spec; returns its python
    executable. Content-hash keyed on the resolved requirement set, built
    atomically (unique tmp dir + rename) so concurrent leases share one
    build (reference: pip.py + uri_cache.py reuse)."""
    import asyncio
    import subprocess
    import sys
    import threading

    install_args: list[str] = []
    key_parts: list[str] = list(spec.get("pip_install_options", []))
    for item in spec["pip"]:
        if "uri" in item:  # local package shipped through the KV
            pkg_dir = await _fetch_pkg(item["uri"], cache_root, kv_get)
            install_args.append(pkg_dir)
            key_parts.append(item["uri"])
        else:
            install_args.append(item["req"])
            key_parts.append(item["req"])
    key = hashlib.sha1(json.dumps(sorted(key_parts)).encode()).hexdigest()[:16]
    venv_dir = os.path.join(cache_root, "venvs", key)
    py = os.path.join(venv_dir, "bin", "python")
    if os.path.exists(py):
        return py  # cache hit

    import asyncio as _aio

    lock = _venv_locks.setdefault(f"{cache_root}:{key}", _aio.Lock())

    def build():
        import glob as _glob

        tmp = f"{venv_dir}.tmp{os.getpid()}_{threading.get_ident()}"
        # --system-site-packages: the job environment LAYERS over the base
        # interpreter (torch and its CUDA build stay importable, so a venv's
        # worker still reaches the card); only the requested
        # packages are isolated per env.
        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages", tmp],
            check=True, capture_output=True,
        )
        # When THIS interpreter is itself a venv, --system-site-packages
        # points at the base python's site-packages, skipping the parent
        # env's (the standard venv-from-venv gap). A .pth appends the
        # parent's site dirs AFTER the new venv's own, so the job's pinned
        # packages still win over the parent's copies.
        parent_sites = [p for p in sys.path if p.rstrip("/").endswith("site-packages")]
        if parent_sites:
            for site_dir in _glob.glob(os.path.join(tmp, "lib", "python*", "site-packages")):
                with open(os.path.join(site_dir, "_raytpu_parent_env.pth"), "w") as f:
                    f.write("\n".join(parent_sites) + "\n")
        cmd = [os.path.join(tmp, "bin", "python"), "-m", "pip", "install",
               "--disable-pip-version-check", "--no-input"]
        cmd += spec.get("pip_install_options", [])
        cmd += install_args
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeEnvSetupError(
                f"pip install failed for runtime_env {spec.get('hash')}:\n{proc.stderr[-2000:]}"
            )
        os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
        try:
            os.rename(tmp, venv_dir)
        except OSError:  # concurrent build won
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)

    async with lock:
        if not os.path.exists(py):  # re-check: another lease built it
            await asyncio.get_running_loop().run_in_executor(None, build)
    return py


# -- conda -------------------------------------------------------------------

def _conda_exe() -> str | None:
    """Conda binary discovery: RAYTPU_CONDA_EXE override (also the test
    seam), then PATH, then the standard CONDA_EXE activation var."""
    import shutil

    for cand in (os.environ.get("RAYTPU_CONDA_EXE"), shutil.which("conda"),
                 os.environ.get("CONDA_EXE")):
        if cand and os.path.exists(cand):
            return cand
    return None


def _conda_yaml(d: dict) -> str:
    """Emit environment.yml from a dict spec ({name?, channels?,
    dependencies?} with the standard nested {"pip": [...]} entry) — tiny
    hand emitter so pyyaml never becomes a dependency of the daemon."""
    lines: list[str] = []
    if d.get("name"):
        lines.append(f"name: {d['name']}")
    for sect in ("channels", "dependencies"):
        if d.get(sect):
            lines.append(f"{sect}:")
            for item in d[sect]:
                if isinstance(item, dict):
                    for k, v in item.items():
                        lines.append(f"  - {k}:")
                        lines.extend(f"    - {x}" for x in v)
                else:
                    lines.append(f"  - {item}")
    return "\n".join(lines) + "\n"


_conda_locks: dict[str, Any] = {}


async def _resolve_conda(spec: dict, cache_root: str) -> str:
    """Python executable for the spec's conda env: a NAMED env resolves
    under the conda base; a dict spec creates a content-hash-keyed env once
    per node (reference: conda.py builds under per-env locks with the same
    cache-or-create shape)."""
    import asyncio
    import subprocess
    import threading

    conda = spec["conda"]
    exe = _conda_exe()
    if exe is None:
        raise RuntimeEnvSetupError(
            "runtime_env requests a conda env but no conda binary is available "
            "on this node (install conda or set RAYTPU_CONDA_EXE)"
        )
    loop = asyncio.get_running_loop()
    if isinstance(conda, str):
        def resolve_named():
            out = subprocess.run([exe, "info", "--base"], capture_output=True,
                                 text=True, check=True).stdout.strip()
            py = (os.path.join(out, "bin", "python") if conda == "base"
                  else os.path.join(out, "envs", conda, "bin", "python"))
            if not os.path.exists(py):
                raise RuntimeEnvSetupError(f"conda env {conda!r} not found ({py} missing)")
            return py

        return await loop.run_in_executor(None, resolve_named)

    key = hashlib.sha1(json.dumps(conda, sort_keys=True).encode()).hexdigest()[:16]
    env_dir = os.path.join(cache_root, "conda", key)
    py = os.path.join(env_dir, "bin", "python")
    if os.path.exists(py):
        return py

    def build():
        import shutil
        import threading as _th

        tmp = f"{env_dir}.tmp{os.getpid()}_{_th.get_ident()}"
        os.makedirs(os.path.dirname(env_dir), exist_ok=True)
        yml = f"{tmp}.yml"
        with open(yml, "w") as f:
            f.write(_conda_yaml(conda))
        proc = subprocess.run(
            [exe, "env", "create", "-y", "-p", tmp, "-f", yml],
            capture_output=True, text=True,
        )
        os.unlink(yml)
        if proc.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeEnvSetupError(
                f"conda env create failed for runtime_env {spec.get('hash')}:\n"
                f"{proc.stderr[-2000:]}"
            )
        try:
            os.rename(tmp, env_dir)
        except OSError:  # concurrent build won
            shutil.rmtree(tmp, ignore_errors=True)

    import asyncio as _aio

    lock = _conda_locks.setdefault(f"{cache_root}:{key}", _aio.Lock())
    async with lock:
        if not os.path.exists(py):
            await loop.run_in_executor(None, build)
    return py


# -- container ----------------------------------------------------------------

def _container_engine() -> str | None:
    """Engine discovery: RAYTPU_CONTAINER_ENGINE override (also the test
    seam), then podman, then docker."""
    import shutil

    cand = os.environ.get("RAYTPU_CONTAINER_ENGINE")
    if cand:
        return cand if os.path.exists(cand) else shutil.which(cand)
    return shutil.which("podman") or shutil.which("docker")


# Env prefixes forwarded into the container (the worker's control-plane
# coordinates + interpreter config; everything else stays host-side).
_CONTAINER_ENV_PREFIXES = ("RAYTPU_", "PYTHON", "CUDA_", "NVIDIA_", "TORCH_")

# Secret-bearing vars are forwarded as VALUE-LESS `--env K` flags: podman and
# docker then inherit the value from the engine client's own environment
# (which Popen receives via env=), so the session MAC secret never appears on
# the engine command line (world-readable via /proc/<pid>/cmdline on
# multi-user hosts — with it, a local user could forge MAC'd frames to the
# pickle RPC plane).
_CONTAINER_SECRET_KEYS = frozenset({"RAYTPU_AUTH_TOKEN"})


def _gpu_flags(engine: str) -> list:
    """The engine's way to hand the host's cards to the container: docker's
    ``--gpus`` (NVIDIA container toolkit), else podman's CDI device name."""
    if "docker" in os.path.basename(engine):
        return ["--gpus", "all"]
    return ["--device", "nvidia.com/gpu=all"]


def container_spawn_command(container: dict, engine: str, env: dict,
                            session_dir: str, repo_root: str,
                            cwd: str | None = None, gpus: bool = True) -> list:
    """The engine invocation that runs the worker inside the image.

    Host networking (the worker serves its gRPC-equivalent port and dials
    the controller by host address), host IPC + /dev/shm (the shared-memory
    object store is a /dev/shm arena the worker maps directly), and the
    session dir + framework repo volume-mounted at identical paths so the
    propagated PYTHONPATH and store path stay valid inside. ``gpus`` (the
    node advertises a GPU) adds the engine's GPU flags. run_options append
    last, so users can override mounts/flags. The image must provide a
    `python` with this framework's dependencies (torch built for CUDA)."""
    args = [
        engine, "run", "--rm",
        "--network=host", "--ipc=host",
        "-v", "/dev/shm:/dev/shm",
        "-v", f"{session_dir}:{session_dir}",
        "-v", f"{repo_root}:{repo_root}",
    ]
    if gpus:
        args += _gpu_flags(engine)
    if cwd:
        # Popen's cwd only moves the host-side engine client; the worker's
        # working_dir must be set INSIDE the container (it is extracted
        # under the session dir, which is volume-mounted at the same path).
        args += ["-w", cwd]
    for k in sorted(env):
        if k.startswith(_CONTAINER_ENV_PREFIXES):
            if k in _CONTAINER_SECRET_KEYS:
                args += ["--env", k]  # value-less: inherited from client env
            else:
                args += ["--env", f"{k}={env[k]}"]
    args += list(container.get("run_options", []))
    args += [container["image"], "python", "-m", "ray_tpu_torch.core.worker_main"]
    return args


async def materialize(spec: dict, cache_root: str, kv_get) -> tuple[dict, list, str | None, str | None, dict | None]:
    """Daemon-side: download/extract packages (cached per URI), build the
    pip venv / conda env if requested, resolve the container engine.
    Returns (env_vars, extra sys.path entries, cwd or None, python
    executable or None, container spec w/ engine or None). ``kv_get`` is an
    async callable uri -> bytes."""
    env_vars = dict(spec.get("env_vars", {}))
    pypath: list[str] = []
    cwd = None
    for pkg in spec.get("pkgs", []):
        dest = await _fetch_pkg(pkg["uri"], cache_root, kv_get)
        pypath.append(dest)
        if pkg["kind"] == "working_dir":
            cwd = dest
    python_exe = None
    if spec.get("pip"):
        python_exe = await _build_venv(spec, cache_root, kv_get)
    if spec.get("conda") is not None:
        python_exe = await _resolve_conda(spec, cache_root)
    container = None
    if spec.get("container") is not None:
        engine = _container_engine()
        if engine is None:
            raise RuntimeEnvSetupError(
                "runtime_env requests a container but neither podman nor docker "
                "is available on this node (set RAYTPU_CONTAINER_ENGINE)"
            )
        container = dict(spec["container"], engine=engine)
    return env_vars, pypath, cwd, python_exe, container
