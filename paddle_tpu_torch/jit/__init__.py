"""The port's training step (the JAX package's ``paddle.jit.TrainStep``)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
