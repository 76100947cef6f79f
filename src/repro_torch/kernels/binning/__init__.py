from .ops import bucketize  # noqa: F401
from .ref import bucketize_ref  # noqa: F401
