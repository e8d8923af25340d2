"""Application-level constructions over the crypto layers: the TRGSW
LUT/CMux-tree evaluator (``lut.py``)."""
