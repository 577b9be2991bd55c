"""Model zoo of the port: GPT (training model and configurations)."""

from .gpt import (GPTAttention, GPTConfig, GPTDecoderLayer, GPTEmbeddings,
                  GPTForCausalLM, GPTMLP, GPTModel, GPTPretrainingCriterion,
                  enable_fused_lmce, gpt2_small, gpt3_1p3b, gpt_tiny,
                  init_decode_weights_numpy, state_dict_from_jax)

__all__ = ["GPTConfig", "gpt_tiny", "gpt2_small", "gpt3_1p3b",
           "init_decode_weights_numpy", "GPTEmbeddings", "GPTAttention",
           "GPTMLP", "GPTDecoderLayer", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "enable_fused_lmce",
           "state_dict_from_jax"]
