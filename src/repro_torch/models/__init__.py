"""Models beyond the trigger's JEDI-net (counterpart of ``repro.models``)."""
