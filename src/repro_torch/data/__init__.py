"""Datasets of the port (``tm_datasets``), drawn from ``torch.Generator``s."""
