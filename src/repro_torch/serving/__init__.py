"""Serving engine and samplers."""
