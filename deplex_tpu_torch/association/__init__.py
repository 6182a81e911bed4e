"""Temporal plane association (the reference's namespace).

Port of ``deplex_tpu.association``: the C++ deplex library reserves
``deplex.association`` with a placeholder (``foo``); here the namespace
re-exports the real capability, frame-to-map plane matching from the SLAM
stack (``slam/association.py``).
"""

from deplex_tpu_torch.slam.association import AssociationParams, Matches, associate


def foo() -> None:
    """The reference's stub (python/deplex/association/foo.py)."""
    print("Foo")


__all__ = ["AssociationParams", "Matches", "associate", "foo"]
