"""Multi-process execution on torch.distributed (helib_tpu.parallel.distributed).

helib_tpu places shardings and lets XLA GSPMD insert the collectives; here
each exchange is written out, and `all_gather` below is the only one the
parallel layer makes.  Each process is one rank of the default process group
and holds one shard:

  * a ("batch", "limb") mesh (parallel/mesh.py) over the ranks: elementwise
    ring ops, automorphisms and the key-switch MACs are limb-local; the
    digit basis extension gathers the coefficient rows over the limb group;
  * the phi(m)-axis four-step transform (parallel/sharded_ntt.py): one
    gather of the block axis per transform direction.

Ranks on one host with one card share it: NCCL refuses two ranks on one
device, so `init_distributed` takes NCCL only when every rank has a card of
its own and gloo otherwise.  gloo exchanges CUDA tensors itself (it stages
them through host memory); the bytes `collectives` counts are those of the
gathered tensors.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

# op name -> {"count", "bytes", "ms"}: every collective of the parallel
# layer, the bytes of its gathered tensor and its host milliseconds
collectives: dict = {}


def reset_collectives():
    collectives.clear()


def read_collectives() -> dict:
    return {k: dict(v) for k, v in collectives.items()}


def all_gather(x: torch.Tensor, group, name: str) -> list:
    """The group's tensors of x's shape, in group-rank order, counted
    under `name`."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(size)]
    t0 = time.perf_counter()
    dist.all_gather(out, x, group=group)
    ms = (time.perf_counter() - t0) * 1e3
    c = collectives.setdefault(name, {"count": 0, "bytes": 0, "ms": 0.0})
    c["count"] += 1
    c["bytes"] += size * x.numel() * x.element_size()
    c["ms"] += ms
    return out


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: str | None = None) -> str:
    """Join the default process group at tcp://coordinator_address (host:port)
    as rank `process_id` of `num_processes`.  The backend defaults to NCCL
    when every rank has a CUDA device of its own (rank i takes cuda:i), and
    to gloo otherwise; returns it."""
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= num_processes else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


def world() -> tuple[int, int]:
    """(rank, size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device) -> torch.device:
    """This rank's device of `device`'s type: its own card under NCCL, the
    shared card (or the host) otherwise."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", torch.cuda.current_device())
    return device


def global_mesh(limb: int | None = None):
    """A ("batch", "limb") mesh over every rank (each must call this with the
    same arguments).  The limb axis stays within one host's ranks
    (LOCAL_WORLD_SIZE, as torchrun sets it; all ranks otherwise), at most 4,
    halved until it divides the world, so the cross-limb gathers stay on the
    host and only the batch axis spans hosts (helib_tpu's rule)."""
    from .mesh import Mesh
    _, n = world()
    local = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if limb is None:
        limb = min(4, local)
    while n % limb:
        limb //= 2
    limb = max(limb, 1)
    return Mesh(n // limb, limb)


def put_global(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's shard [batch/b, k/l, N] of a [batch, k, N] tensor."""
    return mesh.put(x)


def gather_global(mesh, x: torch.Tensor) -> torch.Tensor:
    """Inverse of put_global: every rank's shard gathered into the whole
    [batch, k, N] tensor (on every rank; for checks)."""
    return mesh.gather(x)


def sharded_pipeline(ctx, sk, mesh, global_batch: int):
    """Batched mult+relin with [batch, limb, N] sharding, its example
    arguments this rank's shards (the same program as
    parallel.mesh.sharded_mult_relin)."""
    from .mesh import sharded_mult_relin
    return sharded_mult_relin(ctx, sk, mesh, global_batch)


# ---------------------------------------------------------------------------
# spawning the ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, nprocs: int, rank: int, port: int, backend, args, out):
    try:
        init_distributed(f"127.0.0.1:{port}", nprocs, rank, backend)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: a queue would share tensors' storage
        # through file descriptors that die with this process
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, nprocs: int, *args, backend: str | None = None,
           timeout: float = 1800.0) -> list:
    """Run fn(*args) on `nprocs` spawned ranks of a process group on a free
    localhost port (init_distributed's backend unless `backend` is given);
    returns each rank's result, in rank order.  `fn` must be importable and
    its result picklable (tensors travel by value).  A rank that fails fails the launch: the others
    are stopped and its traceback raised."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, nprocs, r, port, backend, args, out))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.time() + timeout
    try:
        while len(results) < nprocs:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with {dead[0]}")
                if time.time() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            results[rank] = pickle.loads(val)
    finally:
        for p in procs:
            p.join(timeout=60 if len(results) == nprocs else 0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [results[r] for r in range(nprocs)]
