"""Shard-aware stage checkpoints for the staged sharded suite.

Counterpart of ``descriptools_tpu/parallel/ckpt.py``, in its file format.
Every rank writes only its own blocks:

  <ckpt_dir>/<stage>.p<rank>.npz   one atomic file a rank, members keyed
                                   "<name>@<ys>:<ye>:<xs>:<xe>" (GLOBAL
                                   padded-grid block coordinates)
  <ckpt_dir>/<stage>.DONE          completion marker written by rank 0 AFTER
                                   a barrier confirms every rank's file
                                   landed; carries the rasters' dtypes and
                                   shapes and the file count

Because members are keyed by global block coordinates, not by rank, a
resume may use ANOTHER number of ranks over the same block layout: each
rank scans every stage file and reads only the members its blocks need
(npz reads are lazy per member).  The JAX package writes the same files,
so either package resumes the other's stages.

A kill at any point is safe: block files appear atomically (tmp + rename)
and a stage without its DONE marker is recomputed.  The resume decision is
rank 0's, broadcast, so no rank can branch differently on a half-written
directory.
"""

import glob
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from descriptools_tpu_torch.parallel.mesh import ShardedRaster, broadcast
from descriptools_tpu_torch.utils.checkpoint import check_manifest


def _barrier(mesh):
    dist.barrier(group=mesh.group)


def _agree(mesh, flag):
    """Rank 0's bool, everywhere (consistent resume decisions)."""
    return bool(broadcast(mesh, torch.tensor([int(bool(flag))], dtype=torch.int32), 0))


def _key(name, window):
    ys, ye, xs, xe = window
    return f"{name}@{ys}:{ye}:{xs}:{xe}"


def stage_done(path):
    return os.path.exists(path + ".DONE")


def save_stage_sharded(path, arrays):
    """Save a dict of ShardedRasters of one mesh, one file a rank.  A
    collective: every rank calls it."""
    mesh = next(iter(arrays.values())).mesh
    rank = mesh.rank
    _barrier(mesh)
    if rank == 0:
        # Stale files of a killed run with another number of ranks would
        # otherwise survive next to the fresh ones: clear them.
        for f in glob.glob(f"{path}.p*.npz"):
            os.remove(f)
        if os.path.exists(path + ".DONE"):
            os.remove(path + ".DONE")
    _barrier(mesh)

    blocks, meta = {}, {}
    for name, arr in arrays.items():
        host = {b: t.cpu().numpy() for b, t in arr.blocks.items()}
        meta[name] = {"dtype": str(next(iter(host.values())).dtype), "shape": list(arr.shape)}
        for b, a in host.items():
            blocks[_key(name, arr.window(b))] = a
    tmp = f"{path}.p{rank}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **blocks)
    os.replace(tmp, f"{path}.p{rank}.npz")

    _barrier(mesh)
    if rank == 0:
        tmp = path + ".DONE.tmp"
        with open(tmp, "w") as fh:
            json.dump({"arrays": meta, "files": mesh.world}, fh)
        os.replace(tmp, path + ".DONE")
    _barrier(mesh)


def load_stage_sharded(path, mesh):
    """The stage's ShardedRasters on ``mesh``; each rank reads only the npz
    members its blocks cover, whichever rank (or JAX process) wrote them."""
    with open(path + ".DONE") as fh:
        meta = json.load(fh)["arrays"]
    catalog = {}
    for f in sorted(glob.glob(f"{path}.p*.npz")):
        z = np.load(f)
        for k in z.files:
            catalog[k] = z
    out = {}
    for name, m in meta.items():
        gshape = tuple(m["shape"])
        raster = ShardedRaster(mesh, gshape, {})
        for b in mesh.blocks:
            k = _key(name, raster.window(b))
            if k not in catalog:
                raise ValueError(
                    f"checkpoint block {k} missing — the mesh decomposition "
                    f"changed; resume with the same mesh shape"
                )
            raster.blocks[b] = torch.from_numpy(catalog[k][k]).to(mesh.device)
        out[name] = raster
    return out


def stage_hook(ckpt_dir, mesh, manifest):
    """Stage hook for ``sharded_suite(..., stage_hook=...)``: load complete
    stages, compute and save incomplete ones.  ``manifest`` guards against
    resuming with another grid, config or block layout
    (``utils.checkpoint.check_manifest``): rank 0 writes or checks it, then
    the others check it, and every rank raises if rank 0 refused it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    err = None
    if mesh.rank == 0:
        try:
            check_manifest(ckpt_dir, manifest)
        except ValueError as e:
            err = e
    if not _agree(mesh, err is None):
        raise err or ValueError(f"checkpoint dir {ckpt_dir} belongs to a different run (rank 0 refused it)")
    if mesh.rank != 0:
        check_manifest(ckpt_dir, manifest)
    resumed = []

    def hook(name, compute):
        path = os.path.join(ckpt_dir, name)
        if _agree(mesh, stage_done(path)):
            resumed.append(name)
            return load_stage_sharded(path, mesh)
        out = compute()
        save_stage_sharded(path, out)
        return out

    hook.resumed = resumed
    return hook
