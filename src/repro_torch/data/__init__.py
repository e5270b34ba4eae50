"""Procedural datasets (numpy; identical arrays per seed to ``repro.data``)."""
