"""Training loops of the port: the assessor's (`cnn.py`), on the optimizers
and loss of `common.py`."""
