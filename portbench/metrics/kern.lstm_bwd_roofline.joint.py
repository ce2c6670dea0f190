"""Backward walks #2 in the traced joint train steps, as a share of their
roofline."""

from portbench.readers import bwd_walk_roofline as read  # noqa: F401
