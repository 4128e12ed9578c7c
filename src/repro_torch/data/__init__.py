"""Tokenizer."""
