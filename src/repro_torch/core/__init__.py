"""Core models of the port: the digital TM, the crossbar mapping, the
variation model, the analog IMBUE crossbar and the energy model."""
