"""Multi-device execution over a list of devices (``mesh.py``): the
x-slab decomposition of the rigid, DEM and coupling steps (``slab.py``)
and the row-sharded step (``sharded.py``)."""
