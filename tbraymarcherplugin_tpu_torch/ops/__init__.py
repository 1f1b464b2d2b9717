"""Operators of the PyTorch port: scene math on tensors, the shear-warp
factorization, illumination propagation, and the five kernel modules
(`composite`, `shearwarp_grad`, `warp`, `tf_alpha`, `light_scan`) with their
plain PyTorch versions and autograd functions. Kernels build on first use
(`_kernels`), never at import."""
