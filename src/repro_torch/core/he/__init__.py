from .interface import get_cipher  # noqa: F401
