"""Overlap-tile inference, and the data axis of a device mesh."""
