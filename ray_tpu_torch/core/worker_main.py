"""Worker process entrypoint (reference:
python/ray/_private/workers/default_worker.py).

Spawned by the node daemon with RAYTPU_* env vars; runs the asyncio IO loop on
the main thread and executes tasks on executor threads. Import stays light:
neither torch nor jax is imported at start-up (torch only if user task code
does).
"""
from __future__ import annotations

import asyncio
import logging
import os
import sys


def main():
    logging.basicConfig(level=os.environ.get("RAYTPU_LOG_LEVEL", "WARNING"))
    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.worker import CoreWorker

    rpc.set_auth_token(os.environ.get("RAYTPU_AUTH_TOKEN", ""))
    if os.environ.get("RAYTPU_CHAOS_SPEC"):
        # Arm the chaos plane before ANY task can execute (the cluster config
        # re-install at registration is a no-op for the identical spec).
        from ray_tpu_torch import chaos

        chaos.install_from_json(os.environ["RAYTPU_CHAOS_SPEC"])
    controller_addr = os.environ["RAYTPU_CONTROLLER_ADDR"]
    core = CoreWorker(mode="worker", controller_addr=controller_addr)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    core.attach_loop(loop)

    async def init():
        try:
            await core._async_init()
        except Exception:
            logging.exception("worker init failed")
            loop.stop()

    # Make the global API usable from inside tasks (nested submission).
    from ray_tpu_torch.core import api

    api._set_global_worker(core)

    # Strong reference: an unreferenced init task can be GC'd mid-await
    # (same latent footgun as CoreWorker.start_driver_sync's init task).
    init_task = loop.create_task(init())  # graftlint: disable=bg-strong-ref  run_forever below keeps this frame (and the ref) alive for the process lifetime
    try:
        loop.run_forever()
    except BaseException as e:
        # Fatal escape from the IO loop: leave a black box behind before the
        # process unwinds (chaos kills dump at their own site; this covers
        # everything else that takes the loop down). Harvested by the daemon
        # with the worker log.
        from ray_tpu_torch.obs import flight

        flight.dump("worker.death", reason=f"worker loop died: {type(e).__name__}: {e}")
        raise
    finally:
        sys.exit(0)


if __name__ == "__main__":
    main()
