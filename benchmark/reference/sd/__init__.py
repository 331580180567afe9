"""Frozen copy of the port's MV-VDM modules (UNet, VAE, CLIP towers, DDIM
and FreeInit, the orbit cameras), every op on its plain float32 path
(``ops.py``); the UNet's products read their operands through
``precision.q`` so that the control can run the same code in float8."""
