"""Workload generation (port of ``repro.data``)."""
