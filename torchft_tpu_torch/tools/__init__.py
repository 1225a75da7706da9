"""Measurement scripts for the port's kernels, run on the card
(``python -m torchft_tpu_torch.tools.<name>``)."""
