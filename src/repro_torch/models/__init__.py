"""Model configuration and the functional decoder."""
