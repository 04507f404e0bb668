"""The port's staged sharded suite across processes: worlds of 1 and 2 gloo
processes on the CPU, each rank owning 8 / world blocks of a (2, 4) mesh.

Counterpart of ``tests/test_multiprocess.py`` (whose worker is
``tests/mp_worker.py``).  This file is also the worker: run as a script,
it joins the group, stages a synthetic basin through
``sharded_suite_staged`` with a flood loader (no rank holds a global
raster), and checks each of its blocks against the port's in-core suite on
the identically padded grid.  45x53 divides by no mesh, so the padding,
the padded-grid downslope origin and the renumbered indices are all
exercised.  Tolerances: indices, HAND, river_fac, downslope, slope, fdist,
threshold, Fit and the class map bitwise; the transcendental rasters
within rtol 2e-5, atol 1e-4.  Workers import no JAX; the in-core suite
they compare with is held to JAX by ``tests/test_torch_pipeline.py``.
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(args_of_rank, world, script=HERE, timeout=240):
    """Start ``world`` workers, ``script`` (this file by default) with
    ``args_of_rank(rank)``; [(rc, output)] once all have ended."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, script, *args_of_rank(r)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("world", [1, 2])
def test_staged_suite_across_process_counts(world):
    port = free_port()
    res = launch(lambda r: [str(port), str(r), str(world)], world)
    for r, (rc, out) in enumerate(res):
        assert rc == 0 and f"WORKER {r} OK" in out, f"worker {r} rc={rc}\n{out[-4000:]}"


def basin_case():
    """The inputs every rank regenerates: 45x53 (seed 5) and a flood map of
    HAND <= 5 from the float64 oracle."""
    import numpy as np

    from descriptools_tpu_torch import oracle
    from descriptools_tpu_torch.constants import NODATA
    from descriptools_tpu_torch.pipeline import PipelineConfig
    from descriptools_tpu_torch.utils.synthetic import synthetic_basin

    dem, fdr, river, fac = synthetic_basin(45, 53, seed=5)
    cfg = PipelineConfig()
    _, idx = oracle.flow_distance_index_oracle(fdr, river, cfg.px)
    hand = oracle.hand_oracle(dem.astype(np.int32), idx)
    flood = ((hand != NODATA) & (hand <= 5)).astype(np.uint8)
    rasters = dict(dem=dem.astype(np.int32), fdr=fdr, river=river, fac=fac.astype(np.int32), flood=flood)
    loaders = {k: (lambda ys, ye, xs, xe, a=v: a[ys:ye, xs:xe]) for k, v in rasters.items()}
    return rasters, loaders, cfg


def check_blocks(out, rasters, mesh, cfg):
    """Hold this rank's blocks of ``out`` (crop=False) against the port's
    in-core suite and host classifier on the padded grid; raises on any
    mismatch."""
    import numpy as np
    import torch

    from descriptools_tpu_torch import pipeline
    from descriptools_tpu_torch.constants import NODATA
    from descriptools_tpu_torch.ops.flow import hand_and_river_fac
    from descriptools_tpu_torch.parallel.mesh import pad_to_mesh

    fills = dict(dem=NODATA, fdr=0, river=0, fac=NODATA, flood=NODATA)
    padded = {k: pad_to_mesh(v.astype(np.int32) if k == "flood" else v, mesh, fills[k])
              for k, v in rasters.items()}
    want = pipeline.descriptor_suite(*pipeline.inputs_to_torch(
        padded["dem"], padded["fdr"], padded["fac"], padded["river"], "cpu"), cfg)
    _, want["river_fac"] = hand_and_river_fac(torch.as_tensor(padded["dem"]), torch.as_tensor(padded["fac"]),
                                              want["indices"])
    exact = ("indices", "hand", "river_fac", "downslope", "slope", "fdist")
    for key in want:
        ref = want[key].numpy()
        got = out[key]
        assert got.shape == ref.shape, (key, got.shape, ref.shape)
        for b, t in got.blocks.items():
            ys, ye, xs, xe = got.window(b)
            if key in exact:
                np.testing.assert_array_equal(t.cpu().numpy(), ref[ys:ye, xs:xe], err_msg=key)
            else:
                np.testing.assert_allclose(t.cpu().numpy(), ref[ys:ye, xs:xe], rtol=2e-5, atol=1e-4,
                                           err_msg=key)
    th, corr, fit, cmap = pipeline.classify_flood(want["hand"].numpy(), padded["flood"])
    assert (out["threshold"], out["correctness"], out["fit"]) == (th, corr, fit), (out["threshold"], th)
    for b, t in out["class_map"].blocks.items():
        ys, ye, xs, xe = out["class_map"].window(b)
        np.testing.assert_array_equal(t.cpu().numpy(), cmap[ys:ye, xs:xe], err_msg="class_map")


def worker(port, rank, world):
    from descriptools_tpu_torch.parallel import make_mesh, multihost, sharded_suite_staged

    multihost.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, device="cpu")
    try:
        rasters, loaders, cfg = basin_case()
        mesh = make_mesh((2, 4), device="cpu")
        assert mesh.blocks == tuple(range(rank * 8 // world, (rank + 1) * 8 // world)), mesh.blocks
        out = sharded_suite_staged(mesh, rasters["dem"].shape, loaders, cfg, downslope_halo=8, crop=False)
        check_blocks(out, rasters, mesh, cfg)
    finally:
        multihost.shutdown()
    print(f"WORKER {rank} OK ({world} processes)")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
