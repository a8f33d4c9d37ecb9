"""Runnable examples of the port (``python -m
randomprojection_tpu_torch.examples.<name>``): the counterparts of the
JAX package's ``examples/multihost.py`` and
``examples/config3_verysparse_tp.py``."""
