"""Command-line entry points of the port (counterpart of ``repro.launch``)."""
