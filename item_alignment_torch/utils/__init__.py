"""Checkpoint import helpers."""
