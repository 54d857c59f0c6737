"""Patch-CNN layers, checkpoints and synthetic weights."""
