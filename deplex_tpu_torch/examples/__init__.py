"""User-facing example programs of the port, one module each, run as
``python -m deplex_tpu_torch.examples.<name>``: ``process_cloud``,
``process_sequence``, ``extract_primitives`` and ``run_slam``. They take the
arguments of the reference package's ``examples/python/*.py`` and print the
same lines, plus ``--device`` (default: the card; ``cpu`` runs the plain
twins)."""
