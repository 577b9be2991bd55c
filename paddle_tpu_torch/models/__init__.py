"""Model configurations of the port (data only in the serving slice)."""

from .gpt import (GPTConfig, gpt2_small, gpt3_1p3b, gpt_tiny,
                  init_decode_weights_numpy)

__all__ = ["GPTConfig", "gpt_tiny", "gpt2_small", "gpt3_1p3b",
           "init_decode_weights_numpy"]
