"""Training: the loop, the crop feed and checkpoints (`data.list_images`
also serves the folder modes)."""
