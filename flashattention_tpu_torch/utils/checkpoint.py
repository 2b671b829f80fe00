"""Checkpoint and restore of parameters, optimizer state and the serving
engine.

Counterpart of ``flashattention_tpu/utils/checkpoint.py`` (``save_checkpoint``
:25, ``load_checkpoint`` :43).  The JAX package writes its array trees with
orbax; the port writes its own format, a directory of three files:

- ``tensors.pt``: every tensor of the tree, ``torch.save``-d as a flat
  ``{name: tensor}`` dict (dtypes, fp8 included, and bits as they are);
- ``tree.json``: the tree's structure, each tensor by its name;
- ``engine_state.json``: an engine's ``state_dict()``, when one is given
  (the JAX package's sidecar).

The tree may hold dicts (string or integer keys, as a ``torch.optim`` state
dict has), lists, tuples, tensors, :class:`~flashattention_tpu_torch.ops.quant.QuantizedWeight`
leaves (stored as their payload and scales tensors and the name of their
logical dtype, never pickled) and JSON scalars (None, bool, int, float,
str).  So ``{"params": params, "opt_state": opt_state.state_dict()}``
round-trips bit for bit, and ``torch.load`` reads the tensors with
``weights_only=True``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import torch

from flashattention_tpu_torch.ops.quant import QuantizedWeight
from flashattention_tpu_torch.utils.device import resolve_device

__all__ = ["save_checkpoint", "load_checkpoint"]

_TENSORS = "tensors.pt"
_TREE = "tree.json"
_ENGINE_FILE = "engine_state.json"
_SCALARS = (type(None), bool, int, float, str)


def _encode(node, tensors: dict, where: str):
    """The JSON structure of ``node``, its tensors added to ``tensors``."""

    def tensor(t):
        name = str(len(tensors))
        tensors[name] = t.detach()
        return name

    if torch.is_tensor(node):
        return {"tensor": tensor(node)}
    if isinstance(node, QuantizedWeight):
        return {"quantized": [tensor(node.payload), tensor(node.scales)], "ldtype": node.ldtype}
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"checkpoint: key {k!r} at {where or 'the root'} is not a str or int")
        return {"dict": [[k, _encode(v, tensors, f"{where}/{k}")] for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, tensors, f"{where}/{i}") for i, v in enumerate(node)]}
    if isinstance(node, _SCALARS):
        return {"value": node}
    raise TypeError(f"checkpoint: cannot store {type(node).__name__} at {where or 'the root'}")


def _decode(node, tensors: dict):
    if "tensor" in node:
        return tensors[node["tensor"]]
    if "quantized" in node:
        payload, scales = node["quantized"]
        return QuantizedWeight(tensors[payload], tensors[scales], node["ldtype"])
    if "dict" in node:
        return {k: _decode(v, tensors) for k, v in node["dict"]}
    if "list" in node:
        return [_decode(v, tensors) for v in node["list"]]
    if "tuple" in node:
        return tuple(_decode(v, tensors) for v in node["tuple"])
    return node["value"]


def save_checkpoint(path: str, tree, *, engine_state: dict | None = None) -> None:
    """Write ``tree`` (parameters, ``{"params": ..., "opt_state": ...}``, ...)
    under the directory ``path``, with an engine ``state_dict`` beside it
    when one is given.

    The checkpoint is written whole into a temporary directory beside
    ``path`` and then renamed to it; an existing checkpoint at ``path`` is
    replaced (moved aside by a rename, then removed), so ``path`` never
    holds a partly written one."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(path)
    tmp = tempfile.mkdtemp(prefix=f".{base}.tmp-", dir=parent)
    try:
        tensors: dict = {}
        structure = _encode(tree, tensors, "")
        torch.save(tensors, os.path.join(tmp, _TENSORS))
        with open(os.path.join(tmp, _TREE), "w") as fh:
            json.dump(structure, fh)
        if engine_state is not None:
            with open(os.path.join(tmp, _ENGINE_FILE), "w") as fh:
                json.dump(engine_state, fh)
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".{base}.old-", dir=parent)
            os.rename(path, old)  # onto an empty directory: replaces it
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_checkpoint(path: str, *, device=None):
    """``(tree, engine_state or None)`` as :func:`save_checkpoint` wrote
    them, every tensor on ``device`` (the card unless the caller asks for
    the CPU) with the dtype and bits it was saved with.  A ``torch.optim``
    state dict in the tree goes back through the optimizer's
    ``load_state_dict``."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    tensors = torch.load(os.path.join(path, _TENSORS), map_location=dev, weights_only=True)
    with open(os.path.join(path, _TREE)) as fh:
        tree = _decode(json.load(fh), tensors)
    engine_state = None
    sidecar = os.path.join(path, _ENGINE_FILE)
    if os.path.exists(sidecar):
        with open(sidecar) as fh:
            engine_state = json.load(fh)
    return tree, engine_state
