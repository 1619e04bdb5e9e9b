"""Dry-run analysis (port of ``repro.analysis``): per-device op costs of a
traced step, op histograms and collective bytes, the roofline and its
tables."""
