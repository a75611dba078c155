"""Line detection and the packed-tree kernels (CUDA, with plain versions)."""
