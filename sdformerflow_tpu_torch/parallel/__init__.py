"""Data parallelism: the devices of a data axis and batch prefetch
(``mesh.py``), multi-process training (``multihost.py``)."""
