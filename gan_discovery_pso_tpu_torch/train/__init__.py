"""Training loops of the port: the assessor's (`cnn.py`) and the inverter's
steps and gradient inversions (`inverter.py`), on the optimizers, losses
and label smoothing of `common.py`."""
