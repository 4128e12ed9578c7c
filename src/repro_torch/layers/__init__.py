"""Norms, linear, rotary embedding, MLP and attention."""
