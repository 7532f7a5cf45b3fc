"""JAX model variables -> the port's ``state_dict``.

Input: the variables of ``fpsg_tpu.models.protonet.ImgPCProtoNet``,
``{"params": ..., "batch_stats": ...}``, as nested dicts of numpy arrays
(``jax.device_get`` of the variables). Output: a dict for
``fpsg_torch.models.ImgPCProtoNet.load_state_dict``.

Rules:
- names follow the JAX tree with ``.`` separators; the JAX wrapper level
  ``pc_encoder_wrap`` is dropped (the port's ``pc_encoder`` is the
  PointNet encoder itself);
- ``kernel`` -> ``weight``: a 3x3 conv's HWIO becomes torch's OIHW; a
  dense ``(in, out)`` becomes torch's ``(out, in)``; the decoder's stacked
  kernels ``(*groups, in, out)`` stay as they are (the fused kernels'
  layout);
- BatchNorm ``scale`` -> ``weight``, ``mean`` -> ``running_mean``,
  ``var`` -> ``running_var``; ``bias`` keeps its name.

The map covers every parameter and BatchNorm buffer the port's model has,
train mode included (the deformer BNs, ``node_bn*`` and the STN BNs): the
tests load it with ``strict=True`` and map JAX gradient trees through it.
No space-to-depth transform: the port's VGG block 1 runs the logical conv.
Loading JAX checkpoint files comes with the slice that ports the CLIs.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DROP = {"pc_encoder_wrap"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _name(path) -> str:
    return ".".join(p for p in path if p not in _DROP)


def _weight(path, a: np.ndarray) -> np.ndarray:
    if path[0] == "pc_decoder":
        return a                                    # stacked: (..., in, out)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)              # HWIO -> OIHW
    if a.ndim == 2:
        return a.T                                  # (in, out) -> (out, in)
    raise ValueError(f"unexpected kernel {'/'.join(path)} {a.shape}")


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict from JAX ``{"params", "batch_stats"}``."""
    out: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(variables.get("params", {})):
        *mod, leaf = path
        if leaf == "kernel":
            name, a = "weight", _weight(path, a)
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        out[_name(mod) + "." + name] = torch.from_numpy(
            np.array(a, np.float32))
    for path, a in _flatten(variables.get("batch_stats", {})):
        *mod, leaf = path
        out[_name(mod) + "." + _STATS[leaf]] = torch.from_numpy(
            np.array(a, np.float32))
    return out
