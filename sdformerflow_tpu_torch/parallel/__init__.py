"""Batch prefetch to the card (``mesh.py``)."""
