# hand-written CUDA kernels, their wrappers and the device sparse layouts
