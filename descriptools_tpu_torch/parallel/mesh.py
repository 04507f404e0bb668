"""A 2-D mesh of equal blocks over the ranks of a ``torch.distributed`` group.

Counterpart of ``descriptools_tpu/parallel/mesh.py``.  In JAX one process
drives several devices and a ``Mesh(('y', 'x'))`` places one block on each.
Here each rank is one process with one compute device, and the mesh is a
block layout: ``ny x nx`` blocks in y-major order, rank r owning the block
ids ``[r k, (r + 1) k)`` with ``k = ny nx / W`` blocks a rank.  A rank may
own several blocks, as a JAX process owns several devices, so one card runs
a real multi-block mesh and a resume may change the number of ranks over
the same block layout.

Bytes between blocks of one rank are device copies.  Bytes between ranks go
through the group, on ``Mesh.comm_device``: the compute device for ``nccl``,
the host for ``gloo``.  The collectives below move their operands there and
back explicitly and count what they hand to the group in ``stats``
(``comm_bytes``, ``comm_calls``).
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """Block layout ``shape = (ny, nx)`` over ``world`` ranks; this rank is
    ``rank``, computes on ``device`` and talks through ``group`` (None: the
    default group) with ``backend``."""

    shape: tuple
    world: int
    rank: int
    device: torch.device
    backend: str
    group: object = field(default=None, compare=False, repr=False)

    @property
    def n_blocks(self):
        return self.shape[0] * self.shape[1]

    @property
    def per_rank(self):
        return self.n_blocks // self.world

    @property
    def blocks(self):
        """This rank's block ids, in order."""
        k = self.per_rank
        return tuple(range(self.rank * k, (self.rank + 1) * k))

    def owner(self, block):
        return block // self.per_rank

    def coords(self, block):
        """(iy, ix) of a block id."""
        return divmod(block, self.shape[1])

    @property
    def comm_device(self):
        """Where the group reads and writes: the card for nccl, else the host."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def _count(stats, nbytes, calls=1):
    if stats is not None:
        stats["comm_bytes"] = stats.get("comm_bytes", 0) + int(nbytes)
        stats["comm_calls"] = stats.get("comm_calls", 0) + calls


def all_reduce(mesh, t, op, stats=None):
    """``t`` (on ``mesh.device``) reduced over the ranks by ``op`` (a
    ``dist.ReduceOp``), on ``mesh.device``."""
    buf = t.to(mesh.comm_device).contiguous()
    _count(stats, buf.numel() * buf.element_size())
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(mesh.device)


def broadcast(mesh, t, src, stats=None):
    """``t`` of rank ``src`` on every rank (every rank passes a tensor of
    the same shape and dtype), on ``mesh.device``."""
    buf = t.to(mesh.comm_device).contiguous()
    _count(stats, buf.numel() * buf.element_size())
    dist.broadcast(buf, src=src, group=mesh.group)
    return buf.to(mesh.device)


def all_gather_blocks(mesh, local, stats=None):
    """Every block's tensor, in block-id order, on ``mesh.device``.

    ``local`` holds one tensor per block of this rank (in ``mesh.blocks``
    order), all of one shape and dtype across the mesh.  One list-form
    ``all_gather`` of each rank's stacked blocks; the result is reordered by
    block id, not by rank."""
    mine = torch.stack(list(local)).to(mesh.comm_device).contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.world)]
    _count(stats, mine.numel() * mine.element_size())
    dist.all_gather(parts, mine, group=mesh.group)
    by_block = {}
    for r, part in enumerate(parts):
        for j, t in enumerate(part):
            by_block[r * mesh.per_rank + j] = t
    return [by_block[b].to(mesh.device) for b in range(mesh.n_blocks)]


def _near_square(n):
    py = int(math.sqrt(n))
    while n % py:
        py -= 1
    return py, n // py


def make_mesh(shape=None, device="cuda", group=None):
    """The mesh of ``shape = (ny, nx)`` blocks over the ranks of ``group``
    (``torch.distributed`` must be initialised: ``multihost.initialize``).

    With no shape, the block count is the world size, factorised as close
    to square as possible (halo traffic scales with each block's
    perimeter).  ``ny nx`` must divide by the world size.  ``device="cuda"``
    computes on the current CUDA device (``multihost.initialize`` sets it
    to the local rank's) and raises where there is no card; ``"cpu"`` only
    when the caller asks."""
    from descriptools_tpu_torch.pipeline import check_device

    device = check_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised; call multihost.initialize()")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    shape = _near_square(world) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] % world or min(shape) < 1:
        raise ValueError(f"mesh {shape}: {shape[0] * shape[1]} blocks do not divide over {world} ranks")
    return Mesh(shape, world, rank, device, dist.get_backend(group), group)


def pad_to_mesh(arr, mesh, fill):
    """Pad a raster (numpy or tensor; bottom and right) so both dims divide
    the mesh shape.

    Padding with the NoData conventions (dem -> -100, fdr -> 0, river -> 0)
    is semantics-preserving for every descriptor: walks entering padding hit
    fdr == 0 dead ends exactly like the reference's border exits, and
    stencils see -100 neighbours exactly like the reference's -100 halo
    ring (slope.py:175-182)."""
    ny, nx = mesh.shape
    r, c = arr.shape
    rp, cp = (-r) % ny, (-c) % nx
    if rp == 0 and cp == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        out = torch.full((r + rp, c + cp), fill, dtype=arr.dtype, device=arr.device)
        out[:r, :c] = arr
        return out
    return np.pad(np.asarray(arr), ((0, rp), (0, cp)), constant_values=fill)


def crop_from_mesh(arr, shape):
    """Undo pad_to_mesh."""
    return arr[: shape[0], : shape[1]]


@dataclass
class ShardedRaster:
    """A raster padded to the mesh, held as this rank's blocks: the
    counterpart of a ``P('y', 'x')`` global ``jax.Array``.  ``shape`` is
    the padded global shape (R, C); ``blocks`` maps each of
    ``mesh.blocks`` to its (R / ny, C / nx) tensor on ``mesh.device``."""

    mesh: Mesh
    shape: tuple
    blocks: dict

    @property
    def block_shape(self):
        return self.shape[0] // self.mesh.shape[0], self.shape[1] // self.mesh.shape[1]

    def window(self, block):
        """(ys, ye, xs, xe) of a block in the padded global grid."""
        h, w = self.block_shape
        iy, ix = self.mesh.coords(block)
        return iy * h, (iy + 1) * h, ix * w, (ix + 1) * w

    def map(self, fn):
        """A raster of ``fn(block tensor)`` per block."""
        return ShardedRaster(self.mesh, self.shape, {b: fn(t) for b, t in self.blocks.items()})

    def gather(self, stats=None):
        """The whole padded raster on every rank (one all-gather), on
        ``mesh.device``.  For small grids and checks: at scale only the
        blocks exist."""
        ny, nx = self.mesh.shape
        every = all_gather_blocks(self.mesh, [self.blocks[b] for b in self.mesh.blocks], stats)
        return torch.cat([torch.cat(every[iy * nx : (iy + 1) * nx], dim=1) for iy in range(ny)], dim=0)
