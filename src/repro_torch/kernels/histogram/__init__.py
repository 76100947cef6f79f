from .ops import (forest_ciphertext_histogram,  # noqa: F401
                  layer_ciphertext_histogram, layer_count_histogram)
from .ref import forest_hist_ref, layer_hist_ref  # noqa: F401
