from .ops import (ciphertext_histogram, count_histogram,  # noqa: F401
                  forest_ciphertext_histogram, layer_ciphertext_histogram,
                  layer_count_histogram)
from .ref import forest_hist_ref, hist_ref, layer_hist_ref  # noqa: F401
