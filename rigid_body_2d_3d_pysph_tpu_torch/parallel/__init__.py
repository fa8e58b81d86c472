"""Multi-device execution: the x-slab decomposition of the rigid and DEM
steps (``slab.py``) over a list of devices (``mesh.py``)."""
