"""Measurement scripts of the port (counterparts of the repo's ``benchmarks/``)."""
