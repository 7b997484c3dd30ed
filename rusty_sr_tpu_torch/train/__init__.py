"""Training (not ported yet); `data.list_images` serves the folder modes."""
