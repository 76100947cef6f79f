from .ops import bucketize, fit_quantile_thresholds  # noqa: F401
from .ref import bucketize_ref  # noqa: F401
