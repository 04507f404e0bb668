"""Halo exchange between the blocks of a mesh (torch.distributed).

Counterpart of ``descriptools_tpu/parallel/halo.py``.  Each block is
extended by ``width`` cells of its neighbours' data on all four sides: a
row phase, then a column phase over the row-extended blocks, so the corners
arrive without diagonal sends.  Positions beyond the global grid are
``fill`` (the NoData ring of the reference, slope.py:175-182).

``width`` may exceed a block's extent: the strip then comes from several
blocks along the axis, each piece straight from the block that holds it
(JAX chains ``ppermute`` hops for the same rows, halo.py:53-66); the
downslope retry needs this on narrow blocks.  A piece between two blocks
of one rank is a device copy.  Pieces between ranks go through one
``dist.batch_isend_irecv`` a phase, posted on every rank in the same order,
sorted by (source block, target block): NCCL matches point-to-point
transfers by order, not by tag.
"""

import torch
import torch.distributed as dist


def _pieces(n, size, width):
    """For each target index t along an axis of ``n`` blocks of ``size``
    cells: [(source s, source lo, source hi, target offset)] of the rows
    ``[t size - width, (t + 1) size + width)`` that lie in other blocks,
    the offset counted in the extended block."""
    out = {}
    for t in range(n):
        lo, hi = t * size - width, (t + 1) * size + width
        parts = []
        for s in range(n):
            if s == t:
                continue
            a, b = max(lo, s * size), min(hi, (s + 1) * size)
            if a < b:
                parts.append((s, a - s * size, b - s * size, a - lo))
        out[t] = parts
    return out


def _take(t, axis, lo, hi):
    return t[lo:hi] if axis == 0 else t[:, lo:hi]


def _exchange_axis(mesh, blocks, width, axis, fill, stats):
    """One phase: every block of this rank extended by ``width`` along
    ``axis`` (0: rows, neighbours in y; 1: columns, neighbours in x)."""
    ny, nx = mesh.shape
    n = ny if axis == 0 else nx
    any_blk = next(iter(blocks.values()))
    size = any_blk.shape[axis]
    pieces = _pieces(n, size, width)

    def block_at(b, k):
        """The block k along the axis in b's row (axis 1) or column (axis 0)."""
        iy, ix = mesh.coords(b)
        return k * nx + ix if axis == 0 else iy * nx + k

    def along(b):
        return mesh.coords(b)[axis]

    mine = set(mesh.blocks)
    out, recv = {}, []
    ops = []
    for dst in range(mesh.n_blocks):
        for s, lo, hi, off in pieces[along(dst)]:
            src = block_at(dst, s)
            if src in mine and dst in mine:
                continue
            if src in mine:
                ops.append((src, dst, "send", _take(blocks[src], axis, lo, hi)))
            elif dst in mine:
                ops.append((src, dst, "recv", (lo, hi, off)))
    ops.sort(key=lambda op: (op[0], op[1]))

    for b in mesh.blocks:
        ext_shape = list(blocks[b].shape)
        ext_shape[axis] += 2 * width
        ext = torch.full(ext_shape, fill, dtype=blocks[b].dtype, device=mesh.device)
        if axis == 0:
            ext[width : width + size] = blocks[b]
        else:
            ext[:, width : width + size] = blocks[b]
        for s, lo, hi, off in pieces[along(b)]:
            src = block_at(b, s)
            if src in mine:
                piece = _take(blocks[src], axis, lo, hi)
                _take(ext, axis, off, off + hi - lo).copy_(piece)
                _add(stats, "halo_bytes", piece.numel() * piece.element_size())
        out[b] = ext

    p2p = []
    for src, dst, kind, payload in ops:
        if kind == "send":
            buf = payload.to(mesh.comm_device).contiguous()
            _add(stats, "halo_bytes", buf.numel() * buf.element_size())
            _add(stats, "comm_bytes", buf.numel() * buf.element_size())
            _add(stats, "comm_calls", 1)
            p2p.append(dist.P2POp(dist.isend, buf, mesh.owner(dst), mesh.group))
        else:
            lo, hi, off = payload
            shape = list(out[dst].shape)
            shape[axis] = hi - lo
            buf = torch.empty(shape, dtype=any_blk.dtype, device=mesh.comm_device)
            recv.append((dst, off, buf))
            p2p.append(dist.P2POp(dist.irecv, buf, mesh.owner(src), mesh.group))
    if p2p:
        for req in dist.batch_isend_irecv(p2p):
            req.wait()
    for dst, off, buf in recv:
        _take(out[dst], axis, off, off + buf.shape[axis]).copy_(buf.to(mesh.device))
    return out


def _add(stats, key, value):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(value)


def halo_exchange(raster, width, fill, stats=None):
    """{block id: block extended by ``width`` cells on all four sides} for
    each block of this rank of the ``ShardedRaster`` ``raster``, corners
    included; ``fill`` beyond the global grid.  A collective: every rank
    calls it.  ``stats`` counts ``halo_bytes`` (strips moved between
    blocks) and, for strips sent to other ranks, ``comm_bytes`` and
    ``comm_calls``."""
    width = int(width)
    if width < 0:
        raise ValueError(f"halo width {width} < 0")
    ext = _exchange_axis(raster.mesh, raster.blocks, width, 0, fill, stats)
    return _exchange_axis(raster.mesh, ext, width, 1, fill, stats)
