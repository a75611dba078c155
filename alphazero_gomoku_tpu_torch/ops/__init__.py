"""Line detection, the packed-tree kernels, the bf16 and int8 network towers
(CUDA, with plain versions), int8 quantization, and their build."""
