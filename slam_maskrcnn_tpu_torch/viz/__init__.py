"""Viewer of the fused volume."""
