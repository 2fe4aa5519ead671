"""Data parallelism: the data axis of one process (`mesh.py`) and the
process group of a multi-process run (`dist.py`)."""
