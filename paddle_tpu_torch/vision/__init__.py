"""Vision (counterpart of ``paddle_tpu.vision``): the model zoo
(``models``), the detection and vision operators (``ops``), the numpy
transforms and the CIFAR and MNIST datasets."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "transforms", "models", "ops"]
