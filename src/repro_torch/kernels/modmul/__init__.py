from .ops import (decrypt_batch, encrypt_batch, modmul_fixed,  # noqa: F401
                  mul_fixed)
from .ref import mul_fixed_ref  # noqa: F401
