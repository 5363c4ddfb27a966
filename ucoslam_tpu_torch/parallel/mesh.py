"""A one-axis group of ranks: the port's counterpart of JAX's `Mesh`.

Port of `ucoslam_tpu/parallel/mesh.py`. JAX shards an array over the devices
of a `Mesh` inside one program; torch.distributed runs one process a rank,
each holding its own shard (SPMD). A `Mesh` here is that group: its
torch.distributed process group (None for a world of one), its size, this
rank and this rank's device. Map-point blocks and their observations shard
over the axis ("pt"); keyframe and marker state is replicated.

`psum` is the reference's `jax.lax.psum` of a tensor or of a tuple of them:
ONE `all_reduce(SUM)` of a packed float32 buffer, so the solvers make as
many collectives as the reference's; `gather_rows` assembles a row-sharded
output on every rank (an all_reduce of the zero-padded shards, which every
backend supports on CPU and CUDA tensors). Both count their calls
(`collectives`, `gathers`), for the tests and chip_smoke.py.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Mesh:
    """One axis of `size` ranks; `rank` is this process's place on it."""

    def __init__(self, group=None, device="cpu", axis: str = "pt"):
        self.group = group
        self.axis = axis
        self.device = torch.device(device)
        if group is None:
            self.size, self.rank = 1, 0
        else:
            self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.collectives = 0  # psum calls
        self.gathers = 0  # gather_rows calls
        self.bytes_reduced = 0  # all_reduce payload of both, float32 bytes

    def __repr__(self) -> str:
        return f"Mesh(axis={self.axis!r}, size={self.size}, rank={self.rank}, device={self.device})"

    def reset_counts(self) -> None:
        self.collectives = self.gathers = self.bytes_reduced = 0

    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        self.bytes_reduced += 4 * flat.numel()
        if self.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return flat

    def psum(self, x):
        """The sum over the mesh of a float32 tensor, or of a tuple / list of
        them (returned as the same kind), in one all_reduce."""
        self.collectives += 1
        parts = list(x) if isinstance(x, (tuple, list)) else [x]
        if self.group is None:
            return x
        for p in parts:
            if p.dtype != torch.float32:
                raise TypeError(f"psum packs float32 tensors, got {p.dtype}")
        flat = self._all_reduce(torch.cat([p.reshape(-1) for p in parts]))
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        if isinstance(x, (tuple, list)):
            return type(x)(out)
        return out[0]

    def gather_rows(self, *shards: torch.Tensor):
        """Each argument is this rank's block of an array sharded on dim 0
        (equal blocks on every rank) -> the whole arrays, on every rank, in
        one all_reduce (bool blocks travel as 0/1 floats)."""
        self.gathers += 1
        if self.group is None:
            return shards if len(shards) > 1 else shards[0]
        bufs = []
        for s in shards:
            full = s.new_zeros((self.size * s.shape[0],) + s.shape[1:], dtype=torch.float32)
            full[self.rank * s.shape[0]:(self.rank + 1) * s.shape[0]] = s.to(torch.float32)
            bufs.append(full)
        flat = self._all_reduce(torch.cat([b.reshape(-1) for b in bufs]))
        out, at = [], 0
        for s, b in zip(shards, bufs):
            v = flat[at:at + b.numel()].reshape(b.shape)
            out.append(v > 0.5 if s.dtype == torch.bool else v.to(s.dtype))
            at += b.numel()
        return tuple(out) if len(out) > 1 else out[0]


def make_mesh(n_devices: int | None = None, axis: str = "pt", device=None) -> Mesh:
    """The mesh over the first `n_devices` ranks of the initialized world
    (all of them by default), on `device` (default: this rank's card);
    without a world, a mesh of one on `device` (default: the card). Called
    by every rank of the world, as
    torch.distributed's group creation requires; a rank outside the first
    n_devices gets None."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} needs an initialized torch.distributed world")
        return Mesh(None, device or "cuda", axis)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    from ucoslam_tpu_torch.parallel.distributed import rank_device

    dev = device or rank_device()
    if n == world:
        return Mesh(dist.group.WORLD, dev, axis)
    group = dist.new_group(list(range(n)))
    return Mesh(group, dev, axis) if dist.get_rank() < n else None
