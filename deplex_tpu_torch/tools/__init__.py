"""Measurement scripts that run the port on a CUDA card (not imported by the package)."""
