"""Files found by name: ``benchmark/<folder>/<name>.py`` under a
checkout's root, loaded as modules.  A job kind (``jobs/``), an input
generator (``generators/``), a kernel's byte count (``kernels/``) and a
per-layer metric's reader (``metrics/``) are each such a file, so that a
later one is added as a file and no file that is there changes."""

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_loaded = {}


def module(folder, name, root=ROOT):
    """``<root>/benchmark/<folder>/<name>.py`` as a module (loaded once)."""
    path = Path(root) / "benchmark" / folder / f"{name}.py"
    if path not in _loaded:
        spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def names(folder, root=ROOT):
    """The names of every file of ``folder``."""
    return sorted(p.stem for p in (Path(root) / "benchmark" / folder).glob("*.py") if p.stem != "__init__")
