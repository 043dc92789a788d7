"""Checkpoints: the two-tier run checkpoints and the published flax format."""
