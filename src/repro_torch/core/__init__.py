"""The port's copy of the scheduling IR (``core/graph.py``)."""
