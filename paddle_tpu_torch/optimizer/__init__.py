"""Optimizers and learning-rate schedulers of the port (the JAX
package's fourteen, with its state names)."""
from . import lr
from .adadelta import Adadelta
from .adagrad import Adagrad
from .adam import Adam
from .adamax import Adamax
from .adamw import AdamW
from .asgd import ASGD
from .lamb import Lamb
from .lbfgs import LBFGS
from .momentum import Momentum
from .nadam import NAdam
from .optimizer import Optimizer
from .radam import RAdam
from .rmsprop import RMSProp
from .rprop import Rprop
from .sgd import SGD

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "Adam", "AdamW",
    "Adamax", "ASGD", "Lamb", "LBFGS", "NAdam", "RAdam", "RMSProp", "Rprop",
    "lr",
]
