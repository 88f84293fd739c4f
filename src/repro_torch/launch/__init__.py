"""Meshes (``mesh.py``) and the dry run of every arch x shape x mesh cell
on ``meta`` tensors (``dryrun.py``)."""
