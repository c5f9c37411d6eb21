# The paper's figures on the port (PyTorch twin of the reference's
# benchmarks/tpch_nested.py, biomedical.py, succinct.py and
# representation.py): python -m repro_torch.figures.<name> [--device cpu].
