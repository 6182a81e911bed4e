"""Frame-batched extraction on one device (parallel/batch.py)."""
