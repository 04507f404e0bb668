"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Counterpart of ``descriptools_tpu/ops/pallas``.  Each wrapper launches its
kernel for CUDA tensors, runs its plain torch version for CPU tensors, and
counts its launches in a plain integer attribute ``launches``.  Nothing is
built or loaded at import: ``build`` compiles ``csrc/*.cu`` at first launch.
"""


def launch_counters():
    """{wrapper name: launches so far} for every kernel wrapper."""
    from descriptools_tpu_torch.ops.cuda import stencil, walk

    return {
        "stencil": stencil.stencil.launches,
        "downslope_walk": walk.downslope_walk.launches,
        "flow_walk": walk.flow_walk.launches,
    }


def reset_launch_counters():
    """Set every wrapper's launch count to 0."""
    from descriptools_tpu_torch.ops.cuda import stencil, walk

    for fn in (stencil.stencil, walk.downslope_walk, walk.flow_walk):
        fn.launches = 0
