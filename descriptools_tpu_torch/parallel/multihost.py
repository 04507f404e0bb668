"""Process-group start-up and per-rank raster staging (torch.distributed).

Counterpart of ``descriptools_tpu/parallel/multihost.py``: process-group
initialisation, a mesh over every rank, and staging that loads only this
rank's blocks, so no process ever holds the global raster (mandatory at
the 1e9-cell target).

    from descriptools_tpu_torch.parallel import multihost
    multihost.initialize()                          # one process per card
    mesh = multihost.global_mesh()                  # one block per rank
    dem = multihost.stage_global(mesh, shape, np.int32, loader)
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from descriptools_tpu_torch.parallel.mesh import ShardedRaster, make_mesh
from descriptools_tpu_torch.placement import check_device


def initialize(init_method=None, world_size=None, rank=None, backend=None, device="cuda"):
    """``torch.distributed.init_process_group`` (idempotent).

    The rank and world size default to ``RANK`` and ``WORLD_SIZE`` and the
    rendezvous to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``), as
    ``torchrun`` sets them; with none of them set, a world of one over an
    in-process ``HashStore`` (JAX's single-process case).  The backend is
    ``nccl`` for a CUDA device and ``gloo`` for ``"cpu"`` unless named.  On
    CUDA the current device becomes ``cuda:<LOCAL_RANK>`` (or the index
    ``device`` names) before the group starts."""
    if dist.is_initialized():
        return
    device = check_device(device)
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if device.type == "cuda":
        local = device.index if device.index is not None else int(env.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
    if world_size is None and init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)
        return
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)


def shutdown():
    """Leave the process group (a no-op when none is initialised)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(shape=None, device="cuda"):
    """The mesh over every rank; by default one block a rank, near-square
    (``mesh.make_mesh``)."""
    return make_mesh(shape=shape, device=device)


def stage_padded(mesh, shape, fill, block_loader, dtype):
    """Stage a global raster PADDED to a mesh-divisible shape.

    ``block_loader(ys, ye, xs, xe)`` reads a window in ORIGINAL raster
    coordinates; positions beyond ``shape`` (the bottom and right padding
    the equal-block decomposition needs) are ``fill``, the NoData
    conventions of ``mesh.pad_to_mesh``, applied per block so no process
    ever holds the global raster.  Each rank calls the loader for its own
    blocks only."""
    ny, nx = mesh.shape
    R = -(-shape[0] // ny) * ny
    C = -(-shape[1] // nx) * nx
    h, w = R // ny, C // nx
    blocks = {}
    for b in mesh.blocks:
        iy, ix = mesh.coords(b)
        ys, xs = iy * h, ix * w
        blk = np.full((h, w), fill, dtype)
        rye, rxe = min(ys + h, shape[0]), min(xs + w, shape[1])
        if ys < shape[0] and xs < shape[1]:
            blk[: rye - ys, : rxe - xs] = np.asarray(block_loader(ys, rye, xs, rxe), dtype=dtype)
        blocks[b] = torch.from_numpy(blk).to(mesh.device)
    return ShardedRaster(mesh, (R, C), blocks)


def stage_global(mesh, shape, dtype, block_loader):
    """Assemble a sharded raster of a ``shape`` that divides the mesh
    without any rank holding it whole: each rank loads only its blocks
    (``block_loader(ys, ye, xs, xe) -> np.ndarray``, e.g. a windowed
    GeoTIFF/Zarr read), so peak host memory is the grid over the ranks."""
    if shape[0] % mesh.shape[0] or shape[1] % mesh.shape[1]:
        raise ValueError(f"stage_global: shape {tuple(shape)} does not divide mesh {mesh.shape}; "
                         "use stage_padded")
    return stage_padded(mesh, shape, 0, block_loader, dtype)
