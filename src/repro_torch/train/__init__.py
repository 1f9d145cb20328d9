"""Training drivers of the port: the replay-buffer ``OnlineTrainer``
(``online``) and the LM train step (``train_step``)."""
