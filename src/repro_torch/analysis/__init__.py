"""Roofline analysis of the port (``analysis/roofline.py``)."""
