"""Probability distributions (counterpart of ``paddle_tpu/distribution``):
23 distributions over a ``Distribution`` base with ``sample``,
``rsample``, ``log_prob``, ``prob``, ``entropy`` and the ``kl_divergence``
registry, and the transforms of ``distribution.transform``. The math is
torch ops on the parameters' device; the draws are PyTorch's samplers fed
by a ``torch.Generator``."""
from . import transform  # noqa: F401
from .distributions import (  # noqa: F401
    Bernoulli,
    Beta,
    Binomial,
    Categorical,
    Cauchy,
    Chi2,
    ContinuousBernoulli,
    Dirichlet,
    Distribution,
    Exponential,
    Gamma,
    Geometric,
    Gumbel,
    Independent,
    Laplace,
    LogNormal,
    Multinomial,
    MultivariateNormal,
    Normal,
    Poisson,
    StudentT,
    TransformedDistribution,
    Uniform,
    kl_divergence,
    register_kl,
)

__all__ = [
    "Distribution", "Normal", "Uniform", "Bernoulli", "Categorical",
    "Exponential", "Laplace", "LogNormal", "Gumbel", "Beta", "Gamma",
    "Dirichlet", "Multinomial", "Poisson", "Geometric", "Binomial",
    "Cauchy", "Chi2", "StudentT", "ContinuousBernoulli",
    "MultivariateNormal", "Independent", "TransformedDistribution",
    "transform", "kl_divergence", "register_kl",
]
