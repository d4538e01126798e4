"""Online safety gates of the runners (NudeNet so far)."""
