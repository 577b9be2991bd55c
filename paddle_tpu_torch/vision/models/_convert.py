"""Weights carried across from the JAX package's models."""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(source, model: torch.nn.Module) -> dict:
    """A state dict for the port's model from the JAX package's model of
    the same constructor and arguments: ``source`` is that layer
    (anything with ``state_dict()`` whose values have ``.numpy()``) or
    its state dict as numpy arrays.  Parameters and buffers keep their
    names: BatchNorm's ``_mean`` / ``_variance``, ``SpectralNorm``'s
    ``weight_u`` / ``weight_v``, and the reparametrised weights of
    ``nn.utils.weight_norm`` (``<name>_g``, ``<name>_v``) and
    ``spectral_norm`` (``<name>_orig`` with the buffers ``<name>_u``,
    ``<name>_v``), which the port's functions name alike.  Conv weights
    keep their ``[out, in/groups, *k]`` layout (``[in, out/groups,
    *k]`` transposed) and ``Linear`` weights their ``[in, out]``.  The
    names and shapes are checked against ``model``'s own: a missing,
    extra or misshapen entry raises.  Returns CPU tensors
    (``load_state_dict`` copies them onto the model's device)."""
    state = source.state_dict() if hasattr(source, "state_dict") \
        else source
    out = {k: torch.as_tensor(np.array(v.numpy() if hasattr(v, "numpy")
                                       else v))
           for k, v in state.items()}
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if set(out) != set(expected):
        raise KeyError(f"state mismatch: missing "
                       f"{sorted(set(expected) - set(out))}, unexpected "
                       f"{sorted(set(out) - set(expected))}")
    for name, shape in expected.items():
        if tuple(out[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != "
                             f"{shape}")
    return out


#: the name the vision zoo's callers use
vision_state_dict_from_jax = state_dict_from_jax
