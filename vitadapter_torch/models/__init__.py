"""Backbones and segmentors."""
