"""Start a world of ranks on one host and collect what each returns.

The counterpart of the virtual mesh that ``--xla_force_host_platform_device_count``
gives the JAX tests: :func:`run_world` spawns ``world_size`` processes, each
one rank of a ``torch.distributed`` world on its own device, runs ``fn`` in
each and returns the ranks' results in rank order.

* Processes start with the ``spawn`` method, never ``fork`` (a forked CUDA
  context is unusable, and the parent may hold threads).
* The ranks meet through a ``FileStore`` in a fresh temporary directory, not
  a TCP port, so that worlds started at once (parallel test workers) cannot
  collide.
* Each rank runs torch on one intra-op thread: a world shares the host's
  cores, and a thread a core in every rank makes each many times slower.
* Devices and backends are explicit: ``device="cuda"`` gives rank ``r``
  ``cuda:{r % device_count}``, ``"cpu"`` the CPU; NCCL refuses two ranks on
  one card, so an NCCL world with more ranks than cards raises before any
  process starts. Nothing switches backend or device by itself.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a world that has not finished by then is stopped (a rank waiting on a
# collective that a dead peer never joins would otherwise wait forever)
TIMEOUT_S = 600.0


def _rank_main(fn, rank, world_size, backend, device, store_path, args, results):
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn: Callable[..., Any], world_size: int, *, backend: str = "nccl",
              device: str = "cuda", args: Sequence[Any] = ()) -> List[Any]:
    """``[fn(device, *args) on rank r for r in range(world_size)]``.

    ``fn`` must be importable (a module-level function: it is pickled by
    name) and return a picklable result; it runs after
    ``init_process_group(backend)`` and receives its rank's device. Raises
    ``RuntimeError`` with the rank's traceback if any rank raises or dies,
    and after ``TIMEOUT_S`` seconds; the other ranks are then terminated.
    """
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"nccl refuses two ranks on one card: {world_size} ranks, "
                             f"{torch.cuda.device_count()} cards (use backend='gloo')")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("device='cuda' but no CUDA device is available")
        # build the kernels once here: ranks building into one directory race
        from efficient_gnns_tpu_torch.ops.cuda import build

        build.load("segment_sum")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="egt_world_")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, backend, device, os.path.join(tmp, "store"), tuple(args),
        results)) for r in range(world_size)]
    out, error = {}, None
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(out) < world_size and error is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    error = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    error = f"the world of {world_size} did not finish in {TIMEOUT_S} s"
                continue
            if ok:
                out[rank] = payload
            else:
                error = f"rank {rank} raised:\n{payload}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return [out[r] for r in range(world_size)]
