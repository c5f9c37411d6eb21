# Hand-written Hopper (sm_90a) kernels for the query path. Each kernel has
# its own module (wrapper + ctypes binding), its CUDA source in csrc/, and
# a plain PyTorch version in ref.py; ops.py dispatches by device.
