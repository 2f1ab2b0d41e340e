"""Model configurations (counterpart of ``repro.configs``)."""
