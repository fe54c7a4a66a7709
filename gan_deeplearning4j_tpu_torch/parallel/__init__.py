"""Trainers of the PyTorch port: one device so far (the mesh trainers wait
for ROADMAP.md queue 1, 'Parallel training')."""

from gan_deeplearning4j_tpu_torch.parallel.trainer import GraphTrainer, TrainState, make_train_state

__all__ = ["GraphTrainer", "TrainState", "make_train_state"]
