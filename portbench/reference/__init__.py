"""The plain reference the benchmark holds the port against.

Plain PyTorch, written from the published descriptions and the reference
repository's semantics (PyTorch3D cameras and ``TexturesUV``, a hard
z-buffer, VGG-19, PyTorch3D's mesh regularizers, Adam), with the
configuration's perceptual loss from ``portbench/losses/<loss>.py``, which
belongs to the reference as these modules do. It imports nothing of the port and takes nothing the port made: it
starts from the arrays the benchmark drew from the seed (``inputs.py``)
and works out the cameras, visibility, shading, targets and updates again.
Its float32 matmuls and convolutions run with TF32 off, switched only
around its own computation (``precision.full_float32``).
"""
