"""Forward walks #1 (ops/lstm -> csrc/lstm_step.cuh fwd_walk) in the traced
CTC train steps, as a share of their roofline."""

from portbench.readers import fwd_walk_roofline as read  # noqa: F401
