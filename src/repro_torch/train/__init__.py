"""Training on one device of the port (counterpart of ``repro.train``):
``optim`` (AdamW) and ``step`` (the train-step builder)."""
