# Seeded synthetic datasets (PyTorch twin of ``repro.data``): a copy of the
# reference's generators, which build plain Python rows with numpy.
