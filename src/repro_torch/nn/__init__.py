"""Layers of the two-tower and GIN models (the port of ``repro/nn``)."""
