"""Entry points (PyTorch twin of ``repro.launch``): ``python -m
repro_torch.launch.train``."""
