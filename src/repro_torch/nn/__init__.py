"""Neural-network substrate of the port (counterpart of ``repro.nn``)."""
