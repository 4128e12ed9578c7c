"""INT4 weight packing."""
