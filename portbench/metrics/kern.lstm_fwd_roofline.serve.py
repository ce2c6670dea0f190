"""Forward walks #1 on the serving path (no cell-state stream), as a share
of their roofline."""

from portbench.readers import fwd_walk_roofline as read  # noqa: F401
