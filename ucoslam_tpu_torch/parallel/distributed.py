"""torch.distributed set-up, the world's mesh, and a local spawner.

Port of `ucoslam_tpu/parallel/distributed.py`. The reference joins JAX's
multi-host rendezvous; the port joins a torch.distributed process group,
one process a rank:

- `init_distributed` joins from arguments, or from the variables torchrun
  sets (`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`).
  With none configured it returns False and changes nothing: the
  single-process fallback, where every solver runs on one device.
- Ranks run on cards unless the caller names the CPU. Backends
  (`world_backend`): NCCL for CUDA ranks (one card a rank), gloo for CPU
  ranks. Two ranks on one card use gloo with CUDA tensors, since NCCL
  refuses two ranks on one device.
- `is_primary` is rank 0 (the rank that writes checkpoints and logs).
- `spawn(fn, n, ...)` starts a world of n ranks on this host in child
  processes ("spawn": each imports only torch and this package), runs
  `fn(mesh, *args)` on every rank and returns each rank's result, its
  tensors as numpy arrays. It is the counterpart of JAX's one-process mesh
  over local devices, for tests, `apps/bench_scaling.py` and chip_smoke.py.
  A rank that raises fails the world: the others are stopped and the error
  is raised with the rank's traceback. A world on cards raises when no
  card is found; `device="cpu"` asks for a CPU world.

Under torch.distributed every rank runs the same sequential-mode program on
the same frames (the SPMD model of the reference's multi-host runs): each
holds the whole map, all reach each bundle adjustment together, the solve
shards the points over the ranks, and every rank applies the same result.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ucoslam_tpu_torch.parallel.mesh import Mesh


def init_distributed(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None) -> bool:
    """Join a torch.distributed group; True when the world has more than one
    rank. Arguments default from torchrun's variables; with neither, returns
    False (one process, nothing initialized). backend: "nccl" when CUDA is
    available, else "gloo"."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_world = os.environ.get("WORLD_SIZE")
    if init_method is None and world_size is None and env_world is None and "MASTER_ADDR" not in os.environ:
        return False
    world_size = int(world_size if world_size is not None else env_world or 1)
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank)
    return world_size > 1


def is_primary() -> bool:
    """True on rank 0, and in a process with no world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device() -> torch.device:
    """This rank's card (`torch.cuda.current_device()`, which the rank set
    on joining); raises without one. A CPU rank names its device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank: pass device='cpu' for a mesh on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(axis: str = "pt", device=None) -> Mesh:
    """The mesh over every rank of the world (a mesh of one without a
    world), on `device`: this rank's card unless the caller names another."""
    if not dist.is_initialized():
        return Mesh(None, device or "cuda", axis)
    return Mesh(dist.group.WORLD, device or rank_device(), axis)


def world_backend(device: str, world_size: int) -> str:
    """The backend of a local world of `world_size` ranks on `device`: gloo
    on the CPU; NCCL with a card a rank ("cuda"); gloo for ranks sharing
    one card ("cuda:N"), which NCCL refuses."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if device == "cuda" or world_size == 1 else "gloo"


# ---------------------------------------------------------------- host trees
def to_host(x):
    """Tensors -> numpy arrays, through dataclasses, tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: to_host(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(to_host, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(to_host, x))
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def to_device(x, device):
    """numpy arrays -> tensors on `device` (the inverse of to_host)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: to_device(getattr(x, f.name), device) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x


# ------------------------------------------------------------------- spawner
def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(job: str, rank: int, world: int, backend: str, device: str, init_method: str, threads, queue):
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)  # written by this world's spawn
        # every rank is on this host: rendezvous over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if threads:
            torch.set_num_threads(int(threads))
        if device.startswith("cuda") and ":" not in device:
            device = f"cuda:{rank % torch.cuda.device_count()}"
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        out = to_host(fn(global_mesh(device=device), *args))
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        queue.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the world
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device: str = "cuda", backend: str | None = None, threads: int | None = None,
          timeout: float = 600.0) -> list:
    """Run `fn(mesh, *args)` on each rank of a new local world of
    `world_size` processes -> [rank 0's result, rank 1's, ...] (tensors as
    numpy). `fn` is a module-level function of an importable module; `args`
    are pickled, so pass numpy arrays (`to_host`). device: "cuda" (rank r
    on card r, the default), "cuda:N" (every rank on that card) or "cpu";
    backend: `world_backend`'s unless given."""
    import multiprocessing
    import queue as queue_mod

    backend = backend or world_backend(device, world_size)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a world on cards: pass device='cpu' for a CPU world")
        if backend == "nccl" and device == "cuda" and torch.cuda.device_count() < world_size:
            raise RuntimeError(f"NCCL takes a card a rank: {world_size} ranks, {torch.cuda.device_count()} cards "
                               "(device='cuda:0' puts every rank on one card over gloo)")

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    # the job travels in a file, not through the start pipe: a parent writes
    # a large argument to that pipe until the child has read it, and would
    # wait forever on a child that died while starting
    tmp = tempfile.TemporaryDirectory(prefix="ucoslam_world_")
    job = os.path.join(tmp.name, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_rank_main, args=(job, r, world_size, backend, device, init_method, threads, q),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size and failure is None:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                gone = [r for r, p in enumerate(procs) if r not in results and p.exitcode is not None]
                if gone:
                    # a rank that died without a word (its report may still be
                    # in the pipe: one last look)
                    try:
                        rank, ok, out = q.get(timeout=2.0)
                    except queue_mod.Empty:
                        failure = f"rank {gone[0]} of {world_size} exited with code {procs[gone[0]].exitcode}"
                        break
                elif time.monotonic() > deadline:
                    failure = f"the world of {world_size} did not finish within {timeout} s"
                    break
                else:
                    continue
            if ok:
                results[rank] = out
            else:
                failure = f"rank {rank} of {world_size} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        tmp.cleanup()
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world_size)]
