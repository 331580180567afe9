"""Plain reference of CogVideoX-5B image-to-video (``cogvideox.py``)."""
