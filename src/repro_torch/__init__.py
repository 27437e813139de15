"""PyTorch + CUDA port of the mixed-precision CNN accelerator serve path.

Mirrors the layout of the JAX package ``repro`` module for module, so a
reader can find each counterpart.  The port imports ``torch`` only; its
two hand-written Hopper kernels (``kernels/mpmm/csrc``) replace the
Pallas kernels ``mpmm_pallas`` and ``conv_mpmm_pallas``.
"""
