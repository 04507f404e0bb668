"""Shard-aware checkpoints of the port's staged sharded suite
(``parallel.ckpt``): a real kill after the ``flow`` stage with 2 gloo
processes, then a resume with 2 and with 1, bitwise, without recomputing
the checkpointed stage; the manifest guard; and the state carried across
packages: a stage directory that the JAX package's ``save_stage_sharded``
wrote on ``make_mesh((2, 4))`` loads into the port with the same keys,
bitwise, and the port's loads into JAX.

Counterpart of ``tests/test_ckpt_sharded.py`` (worker
``tests/mp_ckpt_worker.py``).  This file is also the worker: run as a
script it runs ``sharded_suite_staged`` with ``ckpt_dir`` and either dies
(exit 17) right after the named stage's checkpoint lands or runs to the
end and checks its blocks as ``tests/test_torch_multiprocess.py`` does
(the same tolerances: integers, downslope, slope, fdist, threshold, Fit
and class map bitwise; the transcendental rasters within rtol 2e-5, atol
1e-4).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_multiprocess as mp  # noqa: E402  (the launcher and the checks)

HERE = os.path.abspath(__file__)


def _launch(world, ckpt_dir, kill_stage):
    port = mp.free_port()
    return mp.launch(lambda r: [str(port), str(r), str(world), str(ckpt_dir), kill_stage], world, script=HERE)


def _mtimes(ckpt_dir, stage):
    files = [f for f in os.listdir(ckpt_dir) if f.startswith(stage + ".")]
    assert files, f"no checkpoint files for stage {stage}"
    return {f: os.path.getmtime(os.path.join(ckpt_dir, f)) for f in files}


@pytest.mark.parametrize("resume_world", [2, 1])
def test_kill_after_flow_then_resume(tmp_path, resume_world):
    ckpt_dir = str(tmp_path / "ckpt")
    res = _launch(2, ckpt_dir, "flow")
    assert all(rc == 17 for rc, _ in res), res
    assert os.path.exists(os.path.join(ckpt_dir, "flow.DONE"))
    assert sorted(f for f in os.listdir(ckpt_dir) if f.startswith("flow.p")) == ["flow.p0.npz", "flow.p1.npz"]
    assert not os.path.exists(os.path.join(ckpt_dir, "downslope.DONE"))
    assert not os.path.exists(os.path.join(ckpt_dir, "pointwise.DONE"))
    before = _mtimes(ckpt_dir, "flow")

    # Resume with the same number of ranks, or ONE rank reading the two dead
    # ranks' blocks (the keys are global block coordinates).
    res = _launch(resume_world, ckpt_dir, "-")
    for r, (rc, out) in enumerate(res):
        assert rc == 0 and f"CKPT WORKER {r} OK" in out, f"worker {r} rc={rc}\n{out[-4000:]}"
        assert "resumed ['flow']" in out, out[-2000:]
    assert _mtimes(ckpt_dir, "flow") == before, "the flow stage was recomputed"


@pytest.fixture
def world():
    from descriptools_tpu_torch.parallel import multihost

    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


def test_manifest_guards_mismatched_resume(tmp_path, world):
    """Resuming with another block layout fails loudly."""
    from descriptools_tpu_torch.parallel import make_mesh, sharded_suite_staged

    rasters, loaders, cfg = mp.basin_case()
    del loaders["flood"]
    ckpt_dir = str(tmp_path / "ckpt")
    shape = rasters["dem"].shape
    sharded_suite_staged(make_mesh((2, 4), device="cpu"), shape, loaders, cfg, downslope_halo=8,
                         crop=False, ckpt_dir=ckpt_dir)
    with pytest.raises(ValueError, match="different run"):
        sharded_suite_staged(make_mesh((4, 2), device="cpu"), shape, loaders, cfg, downslope_halo=8,
                             crop=False, ckpt_dir=ckpt_dir)


def _flow_stage(rasters):
    """The flow stage's rasters of 45x53 from the JAX package on
    ``make_mesh((2, 4))`` (crop=False: padded, sharded)."""
    from descriptools_tpu.parallel import make_mesh, sharded_flow_hand

    return dict(zip(("fdist", "indices", "hand", "river_fac"), sharded_flow_hand(
        rasters["dem"], rasters["fdr"], rasters["river"], rasters["fac"], 12.5, make_mesh((2, 4)),
        crop=False)))


def test_loads_a_stage_the_jax_package_wrote(tmp_path, world):
    """The state carried across: JAX's stage files, the port's ShardedRasters
    with the same keys and values, bitwise; a layout they do not cover
    raises JAX's message."""
    from descriptools_tpu.parallel import ckpt as jckpt
    from descriptools_tpu_torch.parallel import ckpt, make_mesh

    rasters, _, _ = mp.basin_case()
    jax_out = _flow_stage(rasters)
    path = str(tmp_path / "flow")
    jckpt.save_stage_sharded(path, jax_out)
    got = ckpt.load_stage_sharded(path, make_mesh((2, 4), device="cpu"))
    assert set(got) == set(jax_out)
    for name, raster in got.items():
        want = np.asarray(jax_out[name])
        assert raster.shape == want.shape == (46, 56)
        for b, t in raster.blocks.items():
            ys, ye, xs, xe = raster.window(b)
            assert t.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(t.numpy(), want[ys:ye, xs:xe], err_msg=name)
    with pytest.raises(ValueError, match="missing"):
        ckpt.load_stage_sharded(path, make_mesh((4, 2), device="cpu"))


def test_the_jax_package_loads_a_stage_the_port_wrote(tmp_path, world):
    from descriptools_tpu.parallel import ckpt as jckpt
    from descriptools_tpu.parallel import make_mesh as j_make_mesh
    from descriptools_tpu_torch.parallel import ckpt, make_mesh, sharded_flow_hand

    rasters, _, _ = mp.basin_case()
    port = dict(zip(("fdist", "indices", "hand", "river_fac"), sharded_flow_hand(
        rasters["dem"], rasters["fdr"], rasters["river"], rasters["fac"], 12.5,
        make_mesh((2, 4), device="cpu"), crop=False)))
    path = str(tmp_path / "flow")
    ckpt.save_stage_sharded(path, port)
    got = jckpt.load_stage_sharded(path, j_make_mesh((2, 4)))
    for name, raster in port.items():
        np.testing.assert_array_equal(np.asarray(got[name]), raster.gather().numpy(), err_msg=name)


def worker(port, rank, world, ckpt_dir, kill_stage):
    from descriptools_tpu_torch.parallel import ckpt, make_mesh, multihost, sharded_suite_staged

    if kill_stage != "-":
        save = ckpt.save_stage_sharded

        def save_then_die(path, arrays):
            save(path, arrays)
            if os.path.basename(path) == kill_stage:
                os._exit(17)

        ckpt.save_stage_sharded = save_then_die
    resumed = []
    real_hook = ckpt.stage_hook

    def watched_hook(*args):
        hook = real_hook(*args)
        resumed.append(hook.resumed)
        return hook

    ckpt.stage_hook = watched_hook
    multihost.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, device="cpu")
    try:
        rasters, loaders, cfg = mp.basin_case()
        mesh = make_mesh((2, 4), device="cpu")
        out = sharded_suite_staged(mesh, rasters["dem"].shape, loaders, cfg, downslope_halo=8,
                                   crop=False, ckpt_dir=ckpt_dir)
        mp.check_blocks(out, rasters, mesh, cfg)
    finally:
        multihost.shutdown()
    print(f"CKPT WORKER {rank} OK ({world} processes); resumed {resumed[0]}")


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
