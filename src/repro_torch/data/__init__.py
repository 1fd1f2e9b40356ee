"""Training data of the port (counterpart of ``repro.data``)."""
