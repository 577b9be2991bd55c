"""GPT configurations (counterpart of ``paddle_tpu/models/gpt.py``).

Only the configuration data and the initializer are ported here; the
training ``GPTForCausalLM`` comes with the training slice.  The serving
path consumes weights as a plain numpy tree (the layout of
``paddle_tpu``'s ``extract_decode_params``), loaded through
``inference.serving.decode_model.params_from_numpy``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_flash_attention: bool = True
    recompute: bool = False
    tensor_parallel_degree: int = 1
    context_parallel: str = "ring"


def gpt_tiny(**kw):
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    return GPTConfig(**base)


def gpt2_small(**kw):
    return GPTConfig(**kw)


def gpt3_1p3b(**kw):
    base = dict(vocab_size=50304, hidden_size=2048,
                num_hidden_layers=24, num_attention_heads=16,
                intermediate_size=8192, max_position_embeddings=2048)
    base.update(kw)
    return GPTConfig(**base)


def init_decode_weights_numpy(cfg: GPTConfig, seed: int = 0,
                              dtype=np.float32) -> dict:
    """Random decode-weight tree with the GPT initializer: Normal(0,
    ``initializer_range``) matrices and embeddings, zero biases, unit
    LayerNorm scales.  Keys and ``[in, out]`` orientation are those of
    ``extract_decode_params``; drawn from ``numpy.random.default_rng(
    seed)``, so a seed names one set of weights on any machine."""
    rng = np.random.default_rng(seed)
    std = cfg.initializer_range
    D, F = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std)).astype(dtype)

    def const(value, n):
        return np.full((n,), value, dtype=dtype)

    tree = {"wte": normal(cfg.vocab_size, D),
            "wpe": normal(cfg.max_position_embeddings, D),
            "lnf_w": const(1.0, D), "lnf_b": const(0.0, D),
            "layers": []}
    for _ in range(cfg.num_hidden_layers):
        tree["layers"].append({
            "ln1_w": const(1.0, D), "ln1_b": const(0.0, D),
            "wqkv": normal(D, 3 * D), "bqkv": const(0.0, 3 * D),
            "wo": normal(D, D), "bo": const(0.0, D),
            "ln2_w": const(1.0, D), "ln2_b": const(0.0, D),
            "w1": normal(D, F), "b1": const(0.0, F),
            "w2": normal(F, D), "b2": const(0.0, D),
        })
    return tree
