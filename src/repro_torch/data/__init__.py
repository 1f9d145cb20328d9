"""Datasets of the port: the TM tasks (``tm_datasets``, drawn from
``torch.Generator``s) and the LM trainer's synthetic token stream
(``pipeline``, numpy)."""
