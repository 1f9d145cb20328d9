"""Optimizers of the port's LM training: AdamW and Adafactor
(``optimizers``) and int8 gradient compression with error feedback
(``compression``)."""
