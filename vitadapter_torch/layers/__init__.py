"""Layers shared by the port's models and heads."""
