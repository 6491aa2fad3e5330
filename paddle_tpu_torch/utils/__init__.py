"""Utilities of the port (``paddle_tpu/utils``): ``download``'s local
data directories."""
