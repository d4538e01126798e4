"""Online safety gates of the runners (NudeNet, Q16), the CLIP-based
evaluators, and the offline metrics (FID/KID/IS on the FID InceptionV3,
CLIPScore, image similarity, style, AES)."""
