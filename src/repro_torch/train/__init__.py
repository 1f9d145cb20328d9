"""Training drivers of the port: the replay-buffer ``OnlineTrainer``."""
