"""Serving steps of the decoder-only models (``launch.steps``)."""
