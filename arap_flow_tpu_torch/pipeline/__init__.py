"""Batch execution and the command-line tools."""
