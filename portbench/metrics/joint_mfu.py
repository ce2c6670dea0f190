"""The joint train step's model operations over the window, against the
card's bf16 dense peak."""

from portbench.readers import train_mfu as read  # noqa: F401
