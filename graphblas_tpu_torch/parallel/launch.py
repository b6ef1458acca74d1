"""Start-up of the distributed tier: one process a rank.

The JAX tier (``graphblas_tpu.parallel``) runs one controller over a
``jax.sharding.Mesh`` and needs nothing of this.  torch.distributed runs
one process per rank, each joined to a process group:

  * ``init`` joins the calling process to a group with the address, rank
    and world size it is given, and a timeout of its own, so a collective
    that never completes raises instead of hanging;
  * ``spawn`` starts ``world_size`` ranks with the ``spawn`` start method
    and a file rendezvous in a temporary directory, runs
    ``fn(rank, world_size, device, *args)`` in each, and joins them
    against a deadline: past it, or as soon as one rank fails, the others
    are terminated and ``spawn`` raises with the failed ranks' tracebacks.

The backend follows the device: NCCL on the card (rank r on ``cuda:r``,
bound as ``device_id``), gloo on the CPU.  Nothing chooses the card when
there is one and the CPU otherwise: the caller names the device.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing import connection

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core import config as CFG

TIMEOUT_S = 300.0   # a collective or a spawned world waits this long at most


def _rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"no distributed backend for device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("graphblas_tpu_torch.parallel: no CUDA card; "
                           "pass device='cpu' to run gloo ranks on the CPU")
    dev = torch.device("cuda", rank if dev.index is None else dev.index)
    if dev.index >= torch.cuda.device_count():
        raise ValueError(f"rank {rank} wants {dev}, but this host has "
                         f"{torch.cuda.device_count()} CUDA cards")
    return dev


def init(rank: int, world_size: int, device, init_method: str,
         timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join this process to the default group as ``rank`` of
    ``world_size`` (``init_method`` "file://..." or "tcp://host:port").
    ``device`` "cpu" takes gloo; "cuda" (rank r on cuda:r) or "cuda:k"
    takes NCCL.  Returns the rank's device."""
    dev = _rank_device(device, rank)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def shutdown() -> None:
    """Leave the default group (no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, world_size, device, init_method, timeout_s, tmp,
               args):
    """Body of a spawned rank: join the group, run ``fn``, leave, and
    pickle its result to ``tmp``; on a failure write the traceback there
    and exit 1 without leaving the group (the parent terminates the
    rest)."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)     # ranks share the host's cores
        dev = init(rank, world_size, device, init_method, timeout_s)
        CFG.set_option("device", str(dev))
        out = fn(rank, world_size, dev, *args)
        shutdown()
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except Exception:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn(fn, world_size: int, device, *args, timeout_s: float = TIMEOUT_S):
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size``
    spawned ranks and return their results in rank order.  ``fn`` must be
    importable by name (a module-level function) and its result
    picklable; each rank's ``device`` option is its device, and a CPU
    rank runs one torch thread.  Raises RuntimeError when a rank fails,
    TimeoutError when the world outlives ``timeout_s``; either way every
    rank has stopped."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("graphblas_tpu_torch.parallel: no CUDA card")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} NCCL ranks need {world_size} "
                             f"cards; this host has "
                             f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gbt_spawn_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, dev.type, init_method,
                                   timeout_s, tmp, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        pending = {p.sentinel: p for p in procs}
        failed = False
        try:
            while pending and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                for s in connection.wait(list(pending), timeout=left):
                    p = pending.pop(s)
                    p.join()
                    failed |= p.exitcode != 0
        finally:
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        detail = ""
        for r in range(world_size):
            path = os.path.join(tmp, f"err{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    detail += f"\n--- rank {r} ---\n{f.read()}"
        if failed or detail:
            codes = {r: p.exitcode for r, p in enumerate(procs)}
            raise RuntimeError(f"spawned ranks failed (exit codes {codes})"
                               + detail)
        if late:
            raise TimeoutError(f"ranks {late} still running after "
                               f"{timeout_s} s; terminated" + detail)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
