"""Card launches per joint CTC-attention train step in the traced window
(train/att_task.make_train_step)."""

from portbench.readers import launches_per_step as read  # noqa: F401
