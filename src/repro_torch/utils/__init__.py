"""Helpers over flat parameter dicts."""
