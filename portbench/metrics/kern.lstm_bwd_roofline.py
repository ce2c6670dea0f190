"""Backward walks #2 (bwd_walk) in the traced CTC train steps, as a share
of their roofline."""

from portbench.readers import bwd_walk_roofline as read  # noqa: F401
