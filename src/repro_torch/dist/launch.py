"""The ranks of one ``torch.distributed`` world, spawned from one process.

The port's counterpart of XLA's host device count: where the reference
asks JAX for N host devices and runs one program over them, the port
runs N processes, one rank each, joined into a process group.

:func:`run_ranks` spawns them (``spawn``, never ``fork``: a forked child
of a CUDA parent cannot use CUDA).  They meet through a ``FileStore`` in
a temporary directory, never a fixed TCP port, so worlds started side by
side (a test suite under xdist) do not collide.  The parent joins them
with a deadline; when a rank raises, the parent kills the others and
raises that rank's traceback.  Each rank's return value comes back
pickled, in rank order.

:func:`join_launcher_world` is the other way in: under a launcher that
sets ``RANK`` and ``WORLD_SIZE`` (``torchrun``), a CLI joins that world.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


class RankError(RuntimeError):
    """A rank of a :func:`run_ranks` world failed; the message holds its
    traceback."""


def default_backend(device, world: int) -> str:
    """NCCL when every rank can have a card of its own, else gloo (the
    CPU, or several ranks sharing one card: NCCL refuses two ranks on
    one device)."""
    kind = torch.device(device).type
    if kind == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_device(device: str, rank: int) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)


def _rank_main(fn, args, rank, world, backend, device, tmp, timeout):
    try:
        _rank_device(device, rank)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        dist.destroy_process_group()
        part = os.path.join(tmp, f"rank{rank}.out.part")
        with open(part, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(part, os.path.join(tmp, f"rank{rank}.out"))
    except BaseException:  # noqa: BLE001 — every failure goes to the parent
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        # no interpreter teardown: the process group's threads may still
        # wait in a collective that the other ranks never enter
        os._exit(1)


def run_ranks(fn: Callable, world: int, *, args: Sequence = (),
              backend: Optional[str] = None, device="cpu",
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` spawned ranks of one process group
    → each rank's return value, in rank order.

    ``fn`` must be importable by its module path (the spawned ranks
    unpickle it).  ``backend`` defaults to :func:`default_backend`.  On
    the CPU each rank runs one thread; on the card rank r takes device
    ``r % device_count`` (every rank ``cuda:0`` on one card).  The
    process group's timeout and the parent's deadline are both
    ``timeout`` seconds.  Raises :class:`RankError` with the first
    failed rank's traceback, or ``TimeoutError``; either way no rank is
    left running.
    """
    if world < 1:
        raise ValueError(f"world of {world} ranks")
    backend = backend or default_backend(device, world)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks.") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, tuple(args), r, world, backend,
                                   str(device), tmp, timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = list(procs)
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{len(pending)} of {world} ranks still running "
                        f"after {timeout:.0f} s")
                wait([p.sentinel for p in pending], timeout=min(left, 1.0))
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        raise RankError(_failure(tmp, procs, r))
                pending = [p for p in pending if p.exitcode is None]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.out"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _failure(tmp: str, procs, first: int) -> str:
    """The traceback written first: the rank that raised, not one whose
    collective then failed on the closed connection to it."""
    errs = [(os.stat(p).st_mtime_ns, r, p) for r in range(len(procs))
            for p in [os.path.join(tmp, f"rank{r}.err")]
            if os.path.exists(p)]
    if not errs:
        return (f"rank {first} of {len(procs)} exited with code "
                f"{procs[first].exitcode}")
    _, r, path = min(errs)
    with open(path) as f:
        return f"rank {r} of {len(procs)} failed:\n{f.read()}"


def join_launcher_world(device) -> bool:
    """Join the world a launcher set up (``RANK`` and ``WORLD_SIZE`` in
    the environment, ``MASTER_ADDR``/``MASTER_PORT`` with them, as
    ``torchrun`` sets them) unless this process is in one already.
    → whether this process is a rank of a world now."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    _rank_device(str(device), int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(default_backend(device, world),
                            init_method="env://", rank=rank,
                            world_size=world)
    return True
