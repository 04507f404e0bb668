"""The port's benchmark harness (``run.py``) and its data."""
