"""Start the ranks of a multi-process run: the launcher that
``torch.distributed`` needs and the JAX package, one controller over all
its devices, does not.

- :func:`spawn` starts ``world_size`` processes (the ``spawn`` start
  method) that meet at a ``FileStore`` in a temporary directory, so no
  port is needed, runs ``fn(*args)`` on each and returns rank 0's result.
  A rank that raises makes the whole spawn raise that exception, with the
  rank's traceback, after the other ranks are killed; a run that passes
  its deadline is killed and raises ``TimeoutError``. Nothing waits
  without a limit.
- :func:`process_group` initializes a one-rank group in this process and
  destroys it on exit (the NCCL code path on one card, say).
- :func:`init_from_env` initializes the group of a ``torchrun`` rank from
  its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``).

The backend is always the caller's: ``nccl`` on cards, ``gloo`` on the CPU
or where the caller asks for it (gloo stages CUDA tensors through host
memory, parallel/collectives.py).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch

# A torchrun rank's group waits this long for its peers.
ENV_TIMEOUT_S = 1800.0


def _init(backend, rank, world_size, store_path, timeout_s, device):
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    dev = torch.device(device) if device is not None else None
    if backend == "nccl":
        if dev is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          rank)))
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend runs on CUDA devices, "
                             f"not {dev}")
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))


@contextlib.contextmanager
def process_group(backend, device=None):
    """A one-rank group in this process, on a FileStore in a temporary
    directory, for the ``with`` block; destroyed after. ``device``: the
    rank's card under nccl (default ``cuda:LOCAL_RANK``)."""
    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="apt_pg_")
    try:
        _init(backend, 0, 1, os.path.join(tmp, "store"), 300.0, device)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(backend):
    """Initialize this ``torchrun`` rank's group (``env://``) on
    ``backend``; under nccl the rank's card is ``cuda:LOCAL_RANK``. Returns
    (rank, world_size)."""
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if v not in os.environ]
    if missing:
        raise RuntimeError(f"not a torchrun rank: {', '.join(missing)} "
                           f"unset")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=ENV_TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def _rank_main(rank, world_size, backend, device, store_path, timeout_s,
               fn, args, results):
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank))
    if device is None or torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        _init(backend, rank, world_size, store_path, timeout_s, device)
        out = fn(*args)
    except BaseException as exc:  # reported to the parent, which raises
        try:
            blob = pickle.dumps(exc)
        except Exception:
            blob = pickle.dumps(RuntimeError(repr(exc)))
        results.put(("error", rank, blob, traceback.format_exc()))
        # The report is in the pipe before this rank's connections close,
        # so it arrives before the errors that the closing gives the
        # ranks still waiting on this one.
        results.close()
        results.join_thread()
        raise
    dist.destroy_process_group()
    results.put(("ok", rank, out if rank == 0 else None))


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=30)


def spawn(fn, world_size, *, backend, device=None, args=(), timeout_s):
    """Run ``fn(*args)`` on ``world_size`` new processes, ranks 0 ..
    world_size - 1 of one ``backend`` group, and return rank 0's result.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    ``device``: every rank's card, made its current CUDA device (under
    nccl the default is ``cuda:rank``); ``fn`` hands it to
    ``parallel.make_mesh`` where its mesh is to live there. With no card,
    each rank runs torch on one thread. The group's own timeout is
    ``timeout_s`` too. Raises the first failing rank's exception (its
    traceback in a note) or ``TimeoutError`` past ``timeout_s``; either
    way every rank is killed first."""
    import multiprocessing as mp

    if world_size < 1:
        raise ValueError("world_size must be at least 1")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="apt_spawn_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, world_size, backend, device, os.path.join(tmp, "store"),
              timeout_s, fn, args, results), daemon=True)
        for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        done, out = set(), None
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world_size - len(done)} of {world_size} ranks "
                    f"still running after {timeout_s} s")
            try:
                msg = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    # Died without a report (a signal, os._exit): the
                    # report may still be in flight, so look once more.
                    try:
                        msg = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"spawn: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no report")
                else:
                    continue
            if msg[0] == "error":
                _, r, blob, tb = msg
                try:
                    exc = pickle.loads(blob)
                except Exception:
                    exc = RuntimeError(f"rank {r} failed")
                exc.add_note(f"raised on rank {r} of {world_size}:\n{tb}")
                raise exc
            done.add(msg[1])
            if msg[1] == 0:
                out = msg[2]
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return out
    finally:
        _kill(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
