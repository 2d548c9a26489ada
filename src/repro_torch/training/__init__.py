"""Training: the microbatched step builder and the two-stage Trainer."""
from repro_torch.training.trainer import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "Trainer", "make_train_step"]
