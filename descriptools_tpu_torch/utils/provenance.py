"""Provenance stamps for evidence artifacts (torch).

Counterpart of ``descriptools_tpu/utils/provenance.py``: ``stamp()`` gives
the git rev, whether the compute-path sources differ from it, and the
torch and CUDA versions; ``engine_sources_changed_since`` tells whether
those sources changed between an artifact's rev and the working tree.
"""

import subprocess
import time

import torch

# Files whose change invalidates on-card evidence: everything on the port's
# compute path (CUDA sources, kernel wrappers, engines, pipeline wiring).
ENGINE_PATHS = (
    "descriptools_tpu_torch/csrc",
    "descriptools_tpu_torch/ops",
    "descriptools_tpu_torch/parallel",
    "descriptools_tpu_torch/pipeline.py",
    "descriptools_tpu_torch/tiled.py",
    "descriptools_tpu_torch/d8.py",
    "descriptools_tpu_torch/constants.py",
    "descriptools_tpu_torch/evaluation.py",
    "descriptools_tpu_torch/oracle",
)


def _git(repo_root, *args):
    out = subprocess.run(
        ["git", *args], capture_output=True, text=True, cwd=repo_root
    )
    return out.returncode, out.stdout.strip()


def git_rev(repo_root):
    rc, rev = _git(repo_root, "rev-parse", "HEAD")
    return rev if rc == 0 else None


def stamp(repo_root):
    """Provenance dict to merge into every evidence artifact;
    ``cuda_version`` is None for a CPU-only torch."""
    rev = git_rev(repo_root)
    rc, _ = _git(repo_root, "diff", "--quiet", "HEAD", "--", *ENGINE_PATHS)
    return {
        "rev": rev,
        "engine_sources_dirty": bool(rc != 0) if rev else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "time_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def engine_sources_changed_since(repo_root, rev):
    """True iff any ENGINE_PATHS file differs between ``rev`` and HEAD
    (including uncommitted changes).  None when git can't answer (missing
    rev, not a repo)."""
    if not rev:
        return None
    rc, _ = _git(repo_root, "cat-file", "-e", f"{rev}^{{commit}}")
    if rc != 0:
        return None
    rc, _ = _git(repo_root, "diff", "--quiet", rev, "--", *ENGINE_PATHS)
    return rc != 0
