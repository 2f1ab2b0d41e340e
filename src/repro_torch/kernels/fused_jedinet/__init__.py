"""Whole-network fused JEDI-net kernel (counterpart of ``repro.kernels.fused_jedinet``)."""
