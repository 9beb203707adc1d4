"""The plain references of the benchmark's configurations.

Plain PyTorch only: nothing here imports ``jax``, ``jrender_tpu`` or
``jrender_tpu_torch``.  What follows the port's documented semantics is a
frozen copy of its arithmetic (each function names its original), so the
yardstick does not move when the program does.  ``<config>.py`` is the
reference of one configuration; ``scene``, ``softras`` and ``n3mr`` hold
what the configurations share.
"""
