"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Counterpart of ``descriptools_tpu/ops/pallas``.  Each wrapper launches its
kernel for CUDA tensors, runs its plain torch version for CPU tensors, and
counts its launches in a plain integer attribute ``launches``.  Nothing is
built or loaded at import: ``build`` compiles ``csrc/*.cu`` at first launch.
"""


def _wrappers():
    from descriptools_tpu_torch.ops.cuda import classify, stencil, terrain, walk

    return {
        "stencil": stencil.stencil,
        "downslope_walk": walk.downslope_walk,
        "flow_walk": walk.flow_walk,
        "stencil_padded": stencil.stencil_padded,
        "absorbing_walk": walk.absorbing_walk,
        "downslope_walk_tracked": walk.downslope_walk_tracked,
        "flow_walk_blocked": walk.flow_walk_blocked,
        "cutoff_count": classify.cutoff_count,
        "d8_successor": terrain.d8_successor,
        "accumulation": terrain.accumulation,
    }


def launch_counters():
    """{wrapper name: launches so far} for every kernel wrapper."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counters():
    """Set every wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
