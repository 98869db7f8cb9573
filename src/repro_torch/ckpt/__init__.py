"""Checkpoints in the reference's on-disk layout (port of ``repro.ckpt``)."""
