"""Build and load the port's CUDA kernels (``descriptools_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, at first use, never at import.  The
library lands in ``build/torch_kernels/`` beside the package, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the library already built.  It is loaded with
``ctypes``; each entry point returns ``cudaGetLastError()`` of its launch.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# -fmad=false: no FMA contraction, so float expressions round as written
# (the slope stencil is held bitwise against PyTorch's).  No fast math.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (csrc/*.cu).
SIGNATURES = {
    # dem, fac, fac is int32 (else float32), slope, slope_rad, twi, mod_twi,
    # rows, cols, d_card, d_diag, px*px, n_topo, stream
    "launch_stencil": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _F, _F, _F, _F, _VP],
    # padded (rows+2 x cols+2), fac, fac is int32, slope, slope_rad, twi,
    # mod_twi, rows, cols (of the interior), d_card, d_diag, px*px, n_topo,
    # stream
    "launch_stencil_padded": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _F, _F, _F, _F, _VP],
    # dem, fdr, fdr is int32 (else uint8), downslope, rows, cols, ed,
    # max_steps, c_card, c_diag, stream
    "launch_downslope": [_VP, _VP, _I, _VP, _I, _I, _F, _I, _F, _F, _VP],
    # dem, fdr, fdr is int32, downslope, trunc, win_rows, win_cols (of the
    # window), halo, row0, col0, grid_rows, grid_cols, ed, max_steps,
    # c_card, c_diag, stream
    "launch_downslope_tracked": [
        _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _F, _VP,
    ],
    # the jump walk: fdr_eff, code0, code, a, b, counts, n_counts, scratch,
    # rows, cols, max_steps, rounds (int*, host), stream
    "launch_jump_walk": [
        _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _I, ctypes.POINTER(_I), _VP,
    ],
    # the in-core flow walk: fdr, fdr is int32 (else uint8), river (one
    # byte), fdist, indices, counts, n_counts, scratch (10n ints), rows,
    # cols, max_steps, c_card, c_diag, rounds (int*, host), stream
    "launch_flow_walk": [
        _VP, _I, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _I, _F, _F, ctypes.POINTER(_I), _VP,
    ],
    "jump_walk_bound": [],
    # the anchored fold: fdr_eff, code0, code, dist, a, b, jump_counts,
    # n_jump_counts, scratch, bands, n_bands, rows, cols, c_card, c_diag,
    # max_steps, info (int[3], host: R, P, K), stream
    "launch_flow_walk_blocked": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _F, _F, _I,
        ctypes.POINTER(_I), _VP,
    ],
    "fold_band_width": [],
    # the calibration's counting pass: hand, flood, h00 (on the card), n,
    # cuts (float*, host), k, over, counts (2k + 1 uint64, zeroed), SMs,
    # stream
    "launch_cutoff_count": [_VP, _VP, _VP, ctypes.c_longlong, ctypes.POINTER(_F), _I, _I, _VP, _I, _VP],
    # terrain's D8: dem, dem type (0 float32, 1 int32, 2 int16), fdr, succ,
    # rows, cols, nodata, the diagonal step, stream
    "launch_d8": [_VP, _I, _VP, _VP, _I, _I, _F, _F, _VP],
    # terrain's accumulation: succ (jumped in place), fac, counts, n_counts,
    # scratch (2n + 4 ceil(n / 2) ints), rows, cols, levels, stream
    "launch_accumulation": [_VP, _VP, _VP, _I, _VP, _I, _I, _I, _VP],
}


def find_nvcc():
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_key():
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; raise on the first that fails.
    Returns their combined output."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    logs, failed = [], None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


@functools.cache
def build():
    """Compile (if needed) and return (library path, seconds spent, log)."""
    lib = BUILD_DIR / f"libdescriptools_kernels_{source_key()}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log_path.read_text() if log_path.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{source_key()}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)
        ])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.cache
def library():
    """The loaded kernel library, with every entry point's types declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name, *args):
    """Call entry point ``name``; raise if its launch reported an error."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_cuda_tensor(t, name, dtype, shape):
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_handle(device):
    """PyTorch's current stream on ``device`` as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
