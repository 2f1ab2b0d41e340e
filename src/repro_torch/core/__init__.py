"""JEDI-net core of the port (counterpart of ``repro.core``)."""
