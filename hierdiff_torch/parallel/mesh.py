"""Data parallelism: one process per card in a ``torch.distributed`` group.

Port of ``hierdiff_tpu/parallel/mesh.py``. The JAX package shards every
batch over a 1-D ``data`` mesh and lets XLA insert the gradient all-reduce;
here each rank is a process with its own card (NCCL) or its own CPU threads
(gloo), every rank draws the same global batch and keeps its contiguous rows
(``shard_batch``, as ``PartitionSpec("data")`` splits them), and the
training step all-reduces the gradients itself
(``parallel/train_step.TrainState``). Sampling shards whole chunks: rank r
runs the chunks r, r + size, ... of the single-process plan and the results
are gathered back into index order (``my_share``, ``all_gather_dict``).

A group is joined from ``torchrun``'s environment (``init_data_parallel``),
from an explicit coordinator (``initialize_multihost``), or by ``spawn``,
which starts the ranks itself (the tests and ``entry.dryrun_multichip``).
Nothing here chooses a backend the caller did not name, except NCCL for a
CUDA device and gloo for the CPU when none is named.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from hierdiff_torch.ops.egnn import drop_kernel_caches

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def in_group() -> bool:
    """Whether this process is a rank of an initialised default group."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, size) of the default group; (0, 1) outside one."""
    if in_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def launched_by_torchrun() -> bool:
    """Whether the environment names this process's rank and its rendezvous."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _join(device: torch.device, local_rank: int, backend: Optional[str],
          **init_kw) -> torch.device:
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    dist.init_process_group(backend or default_backend(device), **init_kw)
    return device


def init_data_parallel(device: torch.device, backend: Optional[str] = None) -> torch.device:
    """Join the group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``). On CUDA the rank
    takes the card ``cuda:LOCAL_RANK`` and NCCL is the backend unless
    ``backend`` names another; on the CPU gloo. Returns the rank's device."""
    if not launched_by_torchrun():
        raise RuntimeError(f"no torchrun environment: {TORCHRUN_ENV} must all be set")
    return _join(device, int(os.environ.get("LOCAL_RANK", 0)), backend, init_method="env://",
                 rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[torch.device] = None,
                         backend: Optional[str] = None) -> torch.device:
    """Join a group spread over hosts (``hierdiff_tpu/parallel/mesh.py:29``):
    from ``torchrun``'s environment when no coordinator is given, else at
    ``tcp://coordinator_address`` as rank ``process_id`` of
    ``num_processes``. The rank's card is ``LOCAL_RANK`` (default: the
    process id modulo the visible cards). Returns the rank's device."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if coordinator_address is None:
        return init_data_parallel(device, backend)
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    cards = max(torch.cuda.device_count(), 1) if device.type == "cuda" else 1
    local = int(os.environ.get("LOCAL_RANK", process_id % cards))
    return _join(device, local, backend, init_method=f"tcp://{coordinator_address}",
                 rank=process_id, world_size=num_processes)


def rank_device(device: torch.device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` becomes the rank's current
    card, which ``set_device`` chose on the main thread only, so that work
    handed to other threads (the prefetcher's copies) lands there too."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def barrier() -> None:
    if in_group():
        dist.barrier()


def shard_batch(batch: Dict[str, Any], rank: int, size: int) -> Dict[str, Any]:
    """Rank ``rank``'s contiguous rows of every array of a global batch
    (``PartitionSpec("data")``); raises unless every leading size divides
    by ``size``, as ``NamedSharding`` does."""
    out = {}
    for k, v in batch.items():
        rows, rest = divmod(v.shape[0], size)
        if rest:
            raise ValueError(f"batch key {k!r}: {v.shape[0]} rows do not split over {size} ranks")
        out[k] = v[rank * rows:(rank + 1) * rows]
    return out


def my_share(items: Sequence) -> list:
    """This rank's items of a plan every rank holds: r, r + size, ..."""
    rank, size = world()
    return list(items[rank::size])


def all_gather_dict(local: Dict[Any, Any]) -> Dict[Any, Any]:
    """Every rank's disjoint dict merged, on every rank (keys are plan or
    molecule indices, so the merge puts results back into index order)."""
    if not in_group():
        return dict(local)
    parts: List[Optional[dict]] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, local)
    merged: Dict[Any, Any] = {}
    for part in parts:
        merged.update(part)
    return dict(sorted(merged.items()))


def replicate(module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers broadcast to every rank, in place;
    the kernels' weight caches are dropped, since a broadcast into a
    parameter's storage need not move its version counter."""
    if in_group():
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
        drop_kernel_caches(module)
    return module


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own random stream: ``seed`` itself on
    rank 0, so a single-process run keeps its stream."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


# --- spawned ranks -------------------------------------------------------------


def _rank_main(rank: int, size: int, backend: str, init_file: str, timeout: float,
               fn: Callable, args: tuple, results) -> None:
    torch.set_num_threads(1)    # ranks share the host's cores
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=size, timeout=timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, size: int, backend: str, init_file: Optional[str] = None,
          args: tuple = (), timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` in ``size`` new processes, each a rank of a
    ``backend`` group that meets at ``file://init_file`` (default: a fresh
    temporary file), and return their results by rank. ``fn``, ``args``
    and the results cross process boundaries by pickling: ``fn`` must be a
    module-level function and results plain host data. The ``spawn`` start
    method is used, since a forked child of a process that has touched CUDA
    cannot use it. Each rank runs with one torch thread and, where CUDA is
    available, on card ``rank % device_count``. A rank that raises, dies or
    outlives ``timeout`` seconds makes this raise, after the other ranks are
    stopped."""
    ctx = mp.get_context("spawn")
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="hierdiff-rendezvous-")
        init_file = os.path.join(tmp, "init")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(rank, size, backend, str(init_file), timeout,
                                                  fn, args, results))
             for rank in range(size)]
    out: Dict[int, Any] = {}
    failed: Dict[int, str] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) + len(failed) < size:
            if time.monotonic() > deadline:
                break
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs)
                        if i not in out and i not in failed and p.exitcode is not None}
                if dead:
                    failed.update({i: f"exited with code {c} and no result" for i, c in dead.items()})
                continue
            (out if ok else failed)[rank] = payload
            if failed:   # the other ranks' errors follow within seconds (or they hang)
                deadline = min(deadline, time.monotonic() + 10.0)
        if failed:
            raise RuntimeError("\n".join(f"rank {r} of {size} failed:\n{msg}"
                                          for r, msg in sorted(failed.items())))
        if len(out) < size:
            raise TimeoutError(f"ranks {sorted(set(range(size)) - set(out))} of {size} did "
                               f"not finish within {timeout:.0f} s")
        for i, p in enumerate(procs):
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {i} of {size} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [out[rank] for rank in range(size)]


def run_cli_ranks(main: Callable, argv: Optional[list],
                  device: torch.device) -> Tuple[torch.device, Optional[int]]:
    """How a CLI run with ``--data-parallel`` gets its ranks. Returns the
    device this process works on and, when it spawned the ranks itself, their
    number (the caller then returns at once: the ranks ran the CLI).

    - in a group already (a spawned rank, or a caller that joined one):
      the process is a rank as it is, on its current card
      (``rank_device``);
    - under ``torchrun``: it joins that group (NCCL on CUDA);
    - on CUDA with D > 1 visible cards: it spawns D NCCL ranks, each running
      ``main(argv)`` on its own card, as the JAX package's ``--data-parallel``
      runs on every device;
    - otherwise (one card, or the CPU): one process, no group."""
    if in_group():
        return rank_device(device), None
    argv = sys.argv[1:] if argv is None else list(argv)
    if launched_by_torchrun():
        return init_data_parallel(device), None
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        size = torch.cuda.device_count()
        spawn(_cli_rank, size, "nccl", args=(main, argv), timeout=7 * 24 * 3600.0)
        return device, size
    return device, None


def _cli_rank(main: Callable, argv: Optional[list]) -> None:
    main(argv)   # its result (models, pipelines) stays in the rank
