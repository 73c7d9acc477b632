"""Frozen plain PyTorch references of the benchmark's cells."""
