"""Meshes for the sharded streams (port of tpusdr/parallel/mesh.py).

In JAX a mesh lays shards on devices, and ``shard_map`` moves data between
them with collectives.  The sharded streams (``parallel/halo.py``,
``parallel/channels.py``) make three moves, and a mesh here names them:

  * ``shift_right``: every shard receives its left neighbour's part (JAX's
    ``lax.ppermute`` with ``perm=[(i, i + 1)]``).  The ring wraps: shard 0
    receives the last shard's part, which is the next tick's shard-0 halo;
  * ``all_to_all(split_axis, concat_axis)``: each shard splits its part
    into S chunks and shard j gets chunk j of every shard, joined in shard
    order (``lax.all_to_all(..., tiled=True)``);
  * ``gather``: the shards' parts joined in shard order, on every process.

Data on a mesh is a list of tensors: the parts of this process's shards,
in shard order.  Two back ends:

  * ``LocalMesh`` holds all S shards in one process on one device and runs
    them one after another: the shift is a rotation of the list, the
    all-to-all a regrouping of chunks, the gather a ``cat``;
  * ``DistMesh`` runs over an initialised ``torch.distributed`` process
    group (gloo on the CPU, NCCL on CUDA).  Each rank owns ``S //
    world_size`` consecutive shards, which it loops over in process, as a
    JAX process owns its local devices.  The cross-rank shift is
    ``batch_isend_irecv`` around the ring, the all-to-all
    ``all_to_all_single``, the gather ``all_gather``; complex tensors go
    over the wire as ``view_as_real`` (gloo has no complex dtype).  At
    world size 1 nothing goes over the wire.

An axis name or a tuple of names selects the shards: a tuple is flattened
into one ring in row-major order, as ``halo.py`` flattens ('host', 'chip').
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

Axis = str | Sequence[str]


class Mesh:
    """Named axis sizes, the shards this process owns and the moves
    between shards (subclasses implement the moves)."""

    rank = 0
    world_size = 1

    def __init__(self, shape: Mapping[str, int], device):
        self.shape = {str(a): int(n) for a, n in shape.items()}
        if not self.shape or any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes need sizes of at least 1: {dict(shape)}")
        self.axis_names = tuple(self.shape)
        self.device = torch.device(device)

    def size(self, axis: Axis = "dev") -> int:
        """The number of shards along ``axis`` (a name or a tuple of names)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh has axes {self.axis_names}, not {unknown}")
        return math.prod(self.shape[a] for a in axes)

    def local_shards(self, axis: Axis = "dev") -> range:
        """The global indices of this process's shards along ``axis``."""
        s = self.size(axis)
        if s % self.world_size:
            raise ValueError(f"{s} shards do not divide over {self.world_size} processes")
        per = s // self.world_size
        return range(self.rank * per, (self.rank + 1) * per)

    def shift_right(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        raise NotImplementedError

    def all_to_all(self, parts: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> list[torch.Tensor]:
        raise NotImplementedError

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape}, device={self.device})"


class LocalMesh(Mesh):
    """S shards in this process on one device, run one after another."""

    def shift_right(self, parts):
        parts = list(parts)
        return parts[-1:] + parts[:-1]

    def all_to_all(self, parts, split_axis, concat_axis):
        chunks = [p.chunk(len(parts), dim=split_axis) for p in parts]
        return [torch.cat([c[j] for c in chunks], dim=concat_axis) for j in range(len(parts))]

    def gather(self, parts, dim):
        return torch.cat(list(parts), dim=dim)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of a dtype every back end sends."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _unwire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(buf) if like.is_complex() else buf


class DistMesh(Mesh):
    """The shards of an initialised ``torch.distributed`` process group:
    rank r owns shards [r*L, (r+1)*L), L = S // world_size."""

    def __init__(self, shape: Mapping[str, int], device=None, group=None):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("DistMesh needs an initialised torch.distributed process group")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        backend = str(dist.get_backend(group))
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
        super().__init__(shape, device)
        if (backend == "nccl") != (self.device.type == "cuda"):
            raise ValueError(f"a {backend} process group cannot move tensors on {self.device}")
        total = math.prod(self.shape.values())
        if total % self.world_size:
            raise ValueError(f"a mesh of {total} shards does not divide over {self.world_size} processes")

    def shift_right(self, parts):
        import torch.distributed as dist

        parts = list(parts)
        last = parts[-1]
        if self.world_size > 1:
            send = _wire(last)
            buf = torch.empty_like(send)
            w, r = self.world_size, self.rank
            ops = [dist.P2POp(dist.isend, send, (r + 1) % w, self.group),
                   dist.P2POp(dist.irecv, buf, (r - 1) % w, self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            last = _unwire(buf, last)
        return [last] + parts[:-1]

    def all_to_all(self, parts, split_axis, concat_axis):
        import torch.distributed as dist

        L, W = len(parts), self.world_size
        chunks = [p.chunk(L * W, dim=split_axis) for p in parts]
        # (destination rank, its local shard, this rank's local shard, *chunk)
        send = torch.stack([torch.stack([torch.stack([c[q * L + j] for c in chunks]) for j in range(L)])
                            for q in range(W)])
        recv = send
        if W > 1:
            wire = _wire(send)
            buf = torch.empty_like(wire)
            dist.all_to_all_single(buf, wire, group=self.group)
            recv = _unwire(buf, send)
        # recv: (source rank, this rank's local shard, source's local shard, *chunk)
        out = []
        for j in range(L):
            pieces = recv[:, j].reshape((W * L,) + tuple(recv.shape[3:]))
            out.append(torch.cat(list(pieces.unbind(0)), dim=concat_axis))
        return out

    def gather(self, parts, dim):
        import torch.distributed as dist

        local = torch.cat(list(parts), dim=dim)
        if self.world_size == 1:
            return local
        wire = _wire(local)
        bufs = [torch.empty_like(wire) for _ in range(self.world_size)]
        dist.all_gather(bufs, wire, group=self.group)
        return torch.cat([_unwire(b, local) for b in bufs], dim=dim)


def make_mesh(shape: Mapping[str, int] | int | None = None, axis: str = "dev", device=None) -> Mesh:
    """A mesh.  ``make_mesh(8)``: 8 shards on axis 'dev';
    ``make_mesh({'host': 2, 'chip': 4})``: 2-D.  With an initialised
    ``torch.distributed`` process group it is a ``DistMesh`` over it
    (``shape`` None: one shard a process), otherwise a ``LocalMesh`` (None:
    one shard).  A ``LocalMesh`` is on the card unless ``device`` names
    another; with no card and no ``device`` it raises ``ValueError``."""
    import torch.distributed as dist

    distributed = dist.is_available() and dist.is_initialized()
    if shape is None:
        shape = {axis: dist.get_world_size() if distributed else 1}
    elif isinstance(shape, int):
        shape = {axis: shape}
    if distributed:
        return DistMesh(shape, device)
    if device is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device: pass device='cpu' to run the shards on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    return LocalMesh(shape, device)
