"""Utilities of the port: the roofline (``utils/roofline.py``)."""
