"""Stage checkpointing for long pipelines.

Copy of ``descriptools_tpu/utils/checkpoint.py`` without its orbax branch
(orbax imports jax): each stage is a ``.npz`` written atomically (tmp +
rename), so a kill mid-write never leaves a stage that looks complete.
``pipeline.run_suite_checkpointed`` saves at every stage boundary and
resumes after the last complete stage.  The files are the JAX package's
``.npz`` stages, so either package reads the other's.
"""

import json
import os

import numpy as np


def save_stage(path, arrays):
    """Save a dict of rasters for one pipeline stage (atomic)."""
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path + ".npz")


def stage_exists(path):
    """True when a COMPLETE stage checkpoint exists at ``path``."""
    return os.path.exists(path + ".npz")


def load_stage(path):
    """Load a stage checkpoint: {name: numpy array}."""
    data = np.load(path + ".npz")
    return {k: data[k] for k in data.files}


def check_manifest(ckpt_dir, manifest):
    """Write (or validate against) the run manifest so a resume cannot mix
    checkpoints from a different grid or config."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "manifest.json")
    if os.path.exists(path):
        with open(path) as fh:
            have = json.load(fh)
        if have != manifest:
            raise ValueError(
                f"checkpoint dir {ckpt_dir} belongs to a different run:\n"
                f"  stored:  {have}\n  current: {manifest}"
            )
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, path)
