"""Probes of kernel mechanisms, ported from the repository's ``tools/``."""
