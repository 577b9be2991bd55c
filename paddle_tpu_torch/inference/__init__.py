"""paddle_tpu_torch.inference — only the serving tier is ported so far
(``paddle_tpu.inference``'s ``Config``/``Predictor`` wait for the
``jit`` slice)."""

__all__ = ["serving"]
