# repro_torch — "Scalable Querying of Nested Data" (Smith et al., 2020) on
# PyTorch/CUDA for NVIDIA Hopper. Module for module it mirrors the JAX
# package ``repro``, which stays the reference. Importing it changes no
# global state: every tensor carries an explicit dtype and device.
