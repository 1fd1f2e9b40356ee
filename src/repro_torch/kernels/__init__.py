"""Hand-written Hopper kernels of the port, built from ``csrc/`` at first use.

``ops`` is the public entry point; ``wavelet3d``, ``zfp_transform`` and
``lorenzo`` hold the wrappers, their launch counts and the source notes.
"""
