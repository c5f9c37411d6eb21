"""The LM's training half: optimizers, the train step, checkpoints and
the resumable loop (PyTorch twin of ``repro.train``)."""
