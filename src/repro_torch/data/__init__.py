"""Deterministic, checkpointable token streams (the port of
``repro.data``)."""
