"""Per cent of the traced serving window with no operation on the card."""

from portbench.readers import idle_share as read  # noqa: F401
