"""Example trainers of the port, runnable as modules
(``python -m torchft_tpu_torch.examples.train_ddp``)."""
