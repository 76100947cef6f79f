from .ops import (layer_ciphertext_histogram,  # noqa: F401
                  layer_count_histogram)
from .ref import layer_hist_ref  # noqa: F401
