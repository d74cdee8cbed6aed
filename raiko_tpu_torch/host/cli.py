"""The proof service on the port.

    python -m raiko_tpu_torch.host.cli --device cuda [raiko_tpu.host.cli flags]

runs the reference's service (``raiko_tpu.host.cli.main``), unchanged, with
its device seams bound to the port (``seams.bound``) for the whole process.
``--device`` defaults to ``cuda`` and raises where there is no card.

``BackgroundServer`` serves the same app from a thread of the calling
process, for callers that also host the chain simulator in that process
(``chip_smoke.py``, the tests).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import threading

from aiohttp import web

from raiko_tpu.host import cli as ref_cli

from .. import seams


def parse_args(argv=None) -> tuple[str, list[str]]:
    """Split off ``--device``; the rest are the reference CLI's flags."""
    p = argparse.ArgumentParser("raiko-tpu-torch-host", add_help=False)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args, rest = p.parse_known_args(argv)
    return args.device, rest


def main(argv=None) -> None:
    device, rest = parse_args(argv)
    with seams.bound(device):
        ref_cli.main(rest)


class BackgroundServer:
    """The service of ``main(argv)`` on its own event loop in a thread.

    A context manager: entering binds the seams and returns once the server
    listens; leaving stops the loop, joins the thread and restores the
    seams."""

    def __init__(self, argv):
        self.device, rest = parse_args(argv)
        self.config = ref_cli.parse_opts(rest)
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, name="raiko-host", daemon=True)
        self._stack = contextlib.ExitStack()
        self._error: BaseException | None = None

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        actor, app = ref_cli.build(self.config)
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
        self._stack.enter_context(seams.bound(self.device))
        try:
            self._thread.start()
            if not self._started.wait(60):
                raise RuntimeError("the proof service did not start within 60 s")
            if self._error is not None:
                raise RuntimeError("the proof service failed to start") from self._error
        except BaseException:
            self._stack.close()
            raise
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._thread.is_alive():
                self._loop.call_soon_threadsafe(self._loop.stop)
                self._thread.join(60)
                if self._thread.is_alive():
                    raise RuntimeError("the proof service did not stop within 60 s")
        finally:
            self._stack.close()


if __name__ == "__main__":
    main()
