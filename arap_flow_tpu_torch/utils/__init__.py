"""Configuration and profiling helpers."""
