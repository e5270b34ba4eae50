"""Fault-tolerant training supervision (port of ``repro.runtime``)."""
