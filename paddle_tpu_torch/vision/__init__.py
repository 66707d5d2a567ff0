"""Vision (counterpart of ``paddle_tpu.vision``): the ResNet family
(``models``), the numpy transforms and the CIFAR and MNIST datasets.
The rest of the JAX zoo and ``vision.ops`` are not ported yet (ROADMAP
A11)."""
from . import datasets, models, transforms

__all__ = ["datasets", "transforms", "models"]
