"""Multi-device layout: the logical-axis rules, the mesh's process groups
and the collectives of the port's mesh path (``parallel/sharding.py``)."""
