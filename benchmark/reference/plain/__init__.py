"""A frozen copy of the plain math of the port of SinGS, the benchmark's
reference: the avatar decode, LBS, the tile rasterizer's plain
composite forward and backward, the triplane and its plain backward,
the losses, the exact KNN statistic, the region laplacian and Adam.

The modules keep their names and relative imports; the CUDA launchers
were taken out, so every composite and every triplane backward runs
the plain version on whatever device its tensors live on. Nothing here
imports the measured program, JAX or the JAX package.
"""
