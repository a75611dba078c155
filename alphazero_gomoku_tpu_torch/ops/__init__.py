"""Line detection, the packed-tree kernels and the fused network tower (CUDA,
with plain versions), and their build."""
