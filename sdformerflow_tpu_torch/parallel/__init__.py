"""Data and tensor parallelism: the devices of a data axis and batch
prefetch (``mesh.py``), multi-process training (``multihost.py``), the
sharding of a model over a model axis (``sharding_rules.py``)."""
