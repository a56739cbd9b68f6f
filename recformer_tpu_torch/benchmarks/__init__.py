"""Timing probes of the port's kernels on the card (``python -m recformer_tpu_torch.benchmarks.<name>``)."""
