"""Blocked and multi-card execution of the suite (torch.distributed).

Counterpart of ``descriptools_tpu/parallel``: a mesh of equal blocks over
the ranks of a process group (``mesh``, ``multihost``), the halo exchange
between blocks (``halo``), the boundary-graph reduction that stitches D8
flow across block edges (``boundary``), the suite over the mesh
(``sharded``), shard-aware checkpoints (``ckpt``) and the exact flood-map
calibration on one device or over a mesh (``classify``).  One process per
card; a rank may own several blocks, so one card runs a multi-block mesh.
"""

from descriptools_tpu_torch.parallel import ckpt, multihost
from descriptools_tpu_torch.parallel.halo import halo_exchange
from descriptools_tpu_torch.parallel.mesh import crop_from_mesh, make_mesh, pad_to_mesh
from descriptools_tpu_torch.parallel.sharded import (
    sharded_downslope,
    sharded_flow_hand,
    sharded_slope,
    sharded_suite,
    sharded_suite_staged,
)

__all__ = [
    "make_mesh",
    "pad_to_mesh",
    "crop_from_mesh",
    "halo_exchange",
    "sharded_slope",
    "sharded_flow_hand",
    "sharded_downslope",
    "sharded_suite",
    "sharded_suite_staged",
    "ckpt",
    "multihost",
]
