"""Online safety gates of the runners (NudeNet, Q16) and the CLIP-based
evaluators."""
