"""PyTorch + CUDA port of ``animate3d_tpu``: MV-VDM sampling and training, the 4D
stage (recon, refine, evaluation), the mesh tools and their parallelism.

The package mirrors the JAX package's module names (``ops/attention.py``,
``models/unet_mv.py``, ``pipelines/mv_sampler.py``,
``pipelines/train_mvvdm.py``, ...). Its hot ops are
hand-written Hopper kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``); nothing is compiled or loaded when the package is
imported (the host-side loader ``data/native_loader.py`` is likewise built
with ``g++`` at first use). Every entry point runs on ``cuda`` unless the
caller asks for ``cpu`` (the tests do), and raises when CUDA is asked for and
absent.
"""
