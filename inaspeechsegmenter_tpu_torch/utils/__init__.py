"""Kernel build and host-side helpers."""
