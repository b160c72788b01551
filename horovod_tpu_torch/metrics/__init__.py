"""Measurements of the port's data plane (``overlap``)."""
