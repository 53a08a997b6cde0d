"""pcc_geo_cnn_v2_tpu_torch — the PyTorch/CUDA port of pcc_geo_cnn_v2_tpu.

The learned point-cloud geometry codec of the JAX package, rebuilt on
PyTorch for NVIDIA Hopper GPUs. The JAX package stays the reference; this
package imports none of it. Layout mirrors the JAX package:

- ``models``  — torch transforms, entropy models, compression model
- ``ops``     — voxelization, threshold sweep and full-cloud metrics around
  the hand-written CUDA kernels of ``csrc/``
- ``coding``  — host range coder (own C++ copy) and bitstream container
- ``utils``   — octree partition, PLY IO, synthetic scan clouds
- ``cli``     — compress / decompress entry points
"""

__version__ = "0.1.0"
