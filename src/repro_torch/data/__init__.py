"""Synthetic data generators (counterpart of ``repro.data``)."""
