"""Host CLI (reference host/src/lib.rs Opts :24-118 + bin/main.rs).

    python -m raiko_tpu_torch.host.cli --device cuda --port 8080

Config layering (later wins, reference four-layer merge): built-in
defaults -> --config-path JSON file -> CLI flags -> per-request body
(applied in the handlers).

``--device`` (``cuda``, the default, or ``cpu``) is the torch device of
every request's device work; ``cuda`` raises where torch sees no card.
``BackgroundServer`` serves the same app from a thread of the calling
process, for callers that also host the chain simulator in that process
(``chip_smoke.py``, the tests)."""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import threading

from aiohttp import web

from .. import device as device_mod
from ..chain import SupportedChainSpecs
from ..core.interfaces import merge_json
from ..tasks import get_task_manager
from .actor import HostConfig, ProofActor
from .app import create_app


def parse_opts(argv=None) -> HostConfig:
    p = argparse.ArgumentParser("raiko-tpu-torch-host")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--address", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--concurrency-limit", type=int, default=16)
    p.add_argument("--config-path", default=None)
    p.add_argument("--chain-spec-path", default=None)
    p.add_argument("--cache-path", default=None)
    p.add_argument("--sqlite-file", default=None)
    p.add_argument("--max-db-size", type=int, default=1_073_741_824)
    p.add_argument("--jwt-secret", default=None)
    p.add_argument("--log-level", default="info")
    p.add_argument(
        "--log-path",
        default=None,
        help="directory for rolling JSON-lines logs (ref host/src/bin/main.rs:31-58)",
    )
    args = p.parse_args(argv)
    device = device_mod.get(args.device)
    from .logs import init_logging

    init_logging(args.log_level, args.log_path)

    file_cfg = {}
    if args.config_path:
        with open(args.config_path) as f:
            file_cfg = json.load(f)
    cli_cfg = {
        "address": args.address,
        "port": args.port,
        "concurrency_limit": args.concurrency_limit,
        "cache_dir": args.cache_path,
        "chain_spec_path": args.chain_spec_path,
        "sqlite_path": args.sqlite_file,
        "max_db_size": args.max_db_size,
        "jwt_secret": args.jwt_secret,
    }
    merged = merge_json(file_cfg, {k: v for k, v in cli_cfg.items() if v is not None})
    cfg = HostConfig(
        concurrency_limit=merged.get("concurrency_limit", 16),
        cache_dir=merged.get("cache_dir"),
        chain_spec_path=merged.get("chain_spec_path"),
        sqlite_path=merged.get("sqlite_path"),
        max_db_size=merged.get("max_db_size", 1_073_741_824),
        jwt_secret=merged.get("jwt_secret"),
        address=merged.get("address", "0.0.0.0"),
        port=merged.get("port", 8080),
        device=device,
        default_request={
            k: v
            for k, v in merged.items()
            if k
            not in (
                "address",
                "port",
                "concurrency_limit",
                "cache_dir",
                "chain_spec_path",
                "sqlite_path",
                "max_db_size",
                "jwt_secret",
            )
        },
    )
    return cfg


def build(config: HostConfig):
    chain_specs = SupportedChainSpecs(config.chain_spec_path)
    tasks = get_task_manager(config.sqlite_path, config.max_db_size)
    actor = ProofActor(config, tasks, chain_specs)
    return actor, create_app(actor)


def main(argv=None) -> None:
    config = parse_opts(argv)
    actor, app = build(config)

    async def _run():
        actor.start()
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, config.address, config.port)
        await site.start()
        logging.info(
            "raiko-tpu-torch host listening on %s:%d (device %s)",
            config.address, config.port, config.device,
        )
        while True:
            await asyncio.sleep(3600)

    asyncio.run(_run())


class BackgroundServer:
    """The service of ``main(argv)`` on its own event loop in a thread.

    A context manager: entering returns once the server listens; leaving
    stops the loop and joins the thread."""

    def __init__(self, argv):
        self.config = parse_opts(argv)
        self.device = self.config.device
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, name="raiko-host", daemon=True)
        self._error: BaseException | None = None

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        actor, app = build(self.config)
        self.actor = actor
        runner = web.AppRunner(app)

        async def boot():
            actor.start()
            await runner.setup()
            await web.TCPSite(runner, self.config.address, self.config.port).start()

        try:
            self._loop.run_until_complete(boot())
        except BaseException as exc:  # reported by __enter__, then re-raised there
            self._error = exc
            self._started.set()
            raise
        self._started.set()
        self._loop.run_forever()
        self._loop.run_until_complete(runner.cleanup())
        self._loop.close()

    def __enter__(self) -> "BackgroundServer":
        self._thread.start()
        if not self._started.wait(60):
            raise RuntimeError("the proof service did not start within 60 s")
        if self._error is not None:
            raise RuntimeError("the proof service failed to start") from self._error
        return self

    def __exit__(self, *exc) -> None:
        if self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(60)
            if self._thread.is_alive():
                raise RuntimeError("the proof service did not stop within 60 s")


if __name__ == "__main__":
    main()
