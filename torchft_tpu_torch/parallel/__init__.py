from torchft_tpu_torch.parallel.trainer import TrainStep

__all__ = ["TrainStep"]
