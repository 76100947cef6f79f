from .pipeline import synthetic_tabular  # noqa: F401
