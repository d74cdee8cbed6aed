"""The mesh of the port: a ``torch.distributed`` process group, its
collectives and the launcher that starts its ranks.

The reference runs one JAX controller over a ``jax.sharding.Mesh`` and
``shard_map``.  The port runs SPMD: each rank is a process of its own that
runs the same code on the same (replicated) inputs, and a collective
stands where ``shard_map`` had one.  A ``Mesh`` is passed explicitly, as
the device is; nothing reads a default group.

The collectives hand the backend the tensors on the rank's device: NCCL
takes CUDA tensors, and so does gloo for ``all_to_all_single`` and
``all_gather`` (``tests/test_torch_parallel.py``'s ``cuda`` cases on the
H100, torch 2.11.0+cu128), so several ranks on one card need no host copy
of their own; gloo moves the data through the host itself.

``run_ranks(fn, world, backend, devices, timeout_s)`` spawns ``world``
ranks (start method ``spawn``: a ``fork`` after CUDA is initialised breaks
the children), gives each a ``Mesh`` and returns ``fn(mesh, *args)`` of
every rank in rank order.  If a rank raises or the time runs out, it kills
the others and raises: it never returns a partial result.
"""

from __future__ import annotations

import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group: the group, this rank's device,
    its rank and the group's size, and the backend ("nccl" or "gloo")."""

    group: object
    device: torch.device
    rank: int
    size: int
    backend: str


def all_to_all(mesh: Mesh, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``): `x` is
    cut into ``mesh.size`` blocks along `split_dim`, block j goes to rank j,
    and the blocks received are joined along `concat_dim` in rank order."""
    d = mesh.size
    if x.shape[split_dim] % d:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} is not a multiple of {d}")
    blocks = x.movedim(split_dim, 0)
    blocks = blocks.reshape((d, blocks.shape[0] // d) + blocks.shape[1:]).contiguous()
    recv = torch.empty_like(blocks)
    dist.all_to_all_single(recv, blocks, group=mesh.group)
    return torch.cat([b.movedim(0, split_dim) for b in recv.unbind(0)], dim=concat_dim)


def all_gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (of one shape), joined along `dim` in rank order."""
    send = x.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    return torch.cat(parts, dim=dim)


def barrier(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier(group=mesh.group)


# --- the launcher -----------------------------------------------------------

DEFAULT_TIMEOUT_S = 600.0


def _rank_main(rank, world, backend, device, init_method, timeout_s, refuse, fn, args, results) -> None:
    # a spawned rank inherits none of its parent's refusals: refuse here,
    # before anything of the rank's own is imported
    for name in refuse:
        sys.modules[name] = None
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # CPU ranks share the host's cores
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        mesh = Mesh(dist.group.WORLD, dev, rank, world, backend)
        out = fn(mesh, *args)
        results.put((rank, True, out))
        dist.destroy_process_group()
    except Exception:  # the rank's boundary: the parent raises it
        results.put((rank, False, traceback.format_exc()))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


class Ranks:
    """Ranks started by ``start_ranks``; ``wait()`` returns their results."""

    def __init__(self, procs, results, tmp: str, timeout_s: float):
        self._procs, self._results, self._tmp = procs, results, tmp
        self._deadline = time.monotonic() + timeout_s
        self._timeout_s = timeout_s

    def stop(self) -> None:
        """Kill every rank still running (again: a no-op)."""
        _stop(self._procs)
        if os.path.isdir(self._tmp):
            self._results.close()
            shutil.rmtree(self._tmp, ignore_errors=True)

    def wait(self) -> list:
        """Every rank's result in rank order; raises (and kills the rest) if
        a rank raises, dies or gives nothing before the deadline."""
        procs, world = self._procs, len(self._procs)
        try:
            got: dict = {}
            while len(got) < world:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: ranks {sorted(set(range(world)) - set(got))} "
                                       f"gave no result within {self._timeout_s:g} s")
                try:
                    rank, ok, out = self._results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.name for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_ranks: {dead} exited with no result "
                                           f"(exit codes {[p.exitcode for p in procs]})") from None
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} of {world} raised:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(30)
            return [got[r] for r in range(world)]
        finally:
            self.stop()


def start_ranks(
    fn,
    world: int,
    backend: str,
    devices: list,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    args: tuple = (),
    refuse: tuple = (),
) -> Ranks:
    """Spawn ``world`` ranks, rank r running ``fn(mesh_r, *args)``, and
    return at once; see ``run_ranks``."""
    import multiprocessing as mp

    devices = list(devices)
    if len(devices) != world:
        raise ValueError(f"run_ranks: {len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="raiko_ranks_")
    init_method = "file://" + os.path.join(tmp, "init")
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = seed or "0"  # read by each child's interpreter at start
    procs = []
    try:
        for r in range(world):
            p = ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                            args=(r, world, backend, str(devices[r]), init_method, timeout_s, tuple(refuse),
                                  fn, tuple(args), results))
            p.start()
            procs.append(p)
    except BaseException:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = seed
    return Ranks(procs, results, tmp, timeout_s)


def run_ranks(
    fn,
    world: int,
    backend: str,
    devices: list,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    args: tuple = (),
    refuse: tuple = (),
) -> list:
    """``[fn(mesh_r, *args) for r in range(world)]``, each in a spawned rank.

    `fn` and `args` must pickle (a module-level function); `backend` is
    "nccl" or "gloo" and `devices` names each rank's device ("cuda:0",
    "cpu"; ``dryrun.backend_for`` chooses both); `refuse` names modules
    each rank makes unimportable before it runs.  The children run under
    the parent's PYTHONHASHSEED, or 0 if it has none, so every rank orders
    sets alike and issues the same collectives.  ``init_process_group``
    gets the same timeout, so no rank waits longer in a collective."""
    return start_ranks(fn, world, backend, devices, timeout_s, args, refuse).wait()
