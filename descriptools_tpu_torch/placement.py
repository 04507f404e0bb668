"""The device, engine and dtype policy that every layer of the port shares.

``ENGINES`` are the values of ``PipelineConfig.engine`` (the pipeline's
docstring says what each runs); ``check_device`` keeps a numpy entry point
from falling back to the CPU unasked; ``as_jax_dtypes`` demotes 64-bit
rasters as the JAX package does.  It imports only numpy and torch, so the
ops, the parallel layer and the pipeline above them all read it from here.
"""

import numpy as np
import torch

ENGINES = ("auto", "cuda", "torch", "cuda_blocked", "torch_blocked")
_ON_CUDA = ("cuda", "cuda_blocked")


def resolve_engine(engine, device):
    """``engine`` (one of ENGINES) for inputs on ``device``, "auto" resolved
    to "cuda" or "torch"."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    is_cuda = torch.device(device).type == "cuda"
    if engine == "auto":
        return "cuda" if is_cuda else "torch"
    if engine in _ON_CUDA and not is_cuda:
        raise ValueError(f"engine={engine!r} needs CUDA tensors, got device {device}")
    return engine


def check_device(device):
    """``torch.device(device)``; raises where it names CUDA and no CUDA
    device is available, so a numpy entry point never falls back to the
    CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    return device


# JAX runs with x64 off: ``jnp.asarray`` demotes these to 32 bits.
_JAX_TORCH_DTYPES = {torch.int64: torch.int32, torch.float64: torch.float32}
_JAX_NUMPY_DTYPES = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def as_jax_dtypes(*arrays):
    """Each tensor or numpy array in the dtype the JAX package computes it
    in: int64 as int32 and float64 as float32 (JAX's x64 is off), any
    other dtype as it is.  Every entry point that JAX feeds
    through ``jnp.asarray`` demotes its rasters here, so HAND and GFI on a
    64-bit dem are JAX's in dtype and value."""
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(a.to(_JAX_TORCH_DTYPES.get(a.dtype, a.dtype)))
        else:
            a = np.asarray(a)
            out.append(a.astype(_JAX_NUMPY_DTYPES.get(a.dtype, a.dtype), copy=False))
    return tuple(out)
