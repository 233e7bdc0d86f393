"""Ops: the hand-written CUDA kernels' wrappers and their plain versions."""
