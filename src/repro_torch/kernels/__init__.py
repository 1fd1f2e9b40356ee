"""Hand-written Hopper kernels of the port, built from ``csrc/`` at first use.

``ops`` is the public entry point; ``wavelet3d`` and ``zfp_transform`` hold
the wrappers, their launch counts and the source notes.
"""
