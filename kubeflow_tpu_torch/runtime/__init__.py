"""Training runtime of the port: trainer, optimizer, metrics, supervisor,
bootstrap."""
