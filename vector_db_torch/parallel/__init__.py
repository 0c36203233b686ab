"""The sharded tier: a corpus split over a mesh of devices (``sharded.py``)."""
