"""Forward walks #1 on T, T/2 and T/4 in the traced joint train steps, as a
share of their roofline."""

from portbench.readers import fwd_walk_roofline as read  # noqa: F401
