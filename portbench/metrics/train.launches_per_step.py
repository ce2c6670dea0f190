"""Card launches per train step in the traced window: the train step's
layer (train/*_task.make_train_step)."""

from portbench.readers import launches_per_step as read  # noqa: F401
