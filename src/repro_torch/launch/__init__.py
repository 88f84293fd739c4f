"""Mesh construction (``mesh.py``).  The JAX package's multi-pod AOT dry run
(``launch/dryrun.py``) and its production meshes are not ported yet."""
