from .layers import Layer  # noqa: F401
