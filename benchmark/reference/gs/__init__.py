"""Frozen copy of the port's stage-1 recon path (K-planes deformation,
rasterizer on its coarse route, ARAP, the loss, bucketing and the
per-group Adam), every op plain PyTorch in float32."""
