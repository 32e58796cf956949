"""Per cent of the traced stretch in which the device ran nothing: one
minus the union of device activity over the stretch (on rank 0 for a
cell on several cards)."""

from harness.readers import idle_share as read  # noqa: F401
