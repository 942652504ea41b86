"""Framework checkpoints of any params or state tree.

Port of the JAX package's `models/checkpoint.py` (orbax there). A tree of
dicts (string keys), lists, tuples, tensors, None, Python scalars and the
port's quantized weights (`QuantizedTensor`, `Int4Tensor`,
`QuantizedExpertTensor`, `Int4ExpertTensor`, static fields included) is
saved as one safetensors file, written and read by the port's own code
(models/tensor_files.py): the tensors by their path in the tree, the
tree's structure as JSON in the header's `__metadata__`. No pickle.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import torch

from . import quantized_params as qp
from .tensor_files import TensorFile, save_tensors

FILE_NAME = "checkpoint.safetensors"
_STRUCTURE_KEY = "tree"
_CLASSES = {cls.__name__: cls for cls in (
    qp.QuantizedTensor, qp.Int4Tensor, qp.QuantizedExpertTensor,
    qp.Int4ExpertTensor)}


def _encode(tree, path: str, tensors: Dict[str, torch.Tensor]):
    """The JSON form of `tree`, its tensors collected into `tensors`."""
    if isinstance(tree, torch.Tensor):
        tensors[path] = tree
        return {"tensor": path}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"{path or 'tree'}: dict keys must be strings")
        return {"dict": {k: _encode(v, f"{path}/{k}" if path else k, tensors)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, f"{path}/{i}" if path else str(i), tensors)
                       for i, v in enumerate(tree)]}
    if type(tree).__name__ in _CLASSES and dataclasses.is_dataclass(tree):
        return {"class": type(tree).__name__, "fields": {
            f.name: _encode(getattr(tree, f.name), f"{path}/{f.name}",
                            tensors) for f in dataclasses.fields(tree)}}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"{path or 'tree'}: cannot checkpoint a "
                    f"{type(tree).__name__}")


def _decode(node, tf: TensorFile, device):
    if "tensor" in node:
        return tf.get(node["tensor"]).to(device)
    if "dict" in node:
        return {k: _decode(v, tf, device) for k, v in node["dict"].items()}
    if "list" in node:
        return [_decode(v, tf, device) for v in node["list"]]
    if "tuple" in node:
        return tuple(_decode(v, tf, device) for v in node["tuple"])
    if "class" in node:
        return _CLASSES[node["class"]](**{
            k: _decode(v, tf, device) for k, v in node["fields"].items()})
    return node["value"]


def save_checkpoint(path: str, tree: Any) -> None:
    """Save `tree` to the directory `path` (created if needed; an earlier
    checkpoint there is replaced)."""
    tensors: Dict[str, torch.Tensor] = {}
    structure = _encode(tree, "", tensors)
    os.makedirs(path, exist_ok=True)
    save_tensors(os.path.join(path, FILE_NAME), tensors,
                 metadata={_STRUCTURE_KEY: json.dumps(structure)})


def check_like(got, want, exact: bool = False, path: str = "tree") -> None:
    """Raise ValueError where `got` differs from the template `want` in
    structure, a tensor's shape or dtype, or a static field; with `exact`,
    also where a tensor's values differ (bit for bit)."""
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or (
                got.shape, got.dtype) != (want.shape, want.dtype):
            desc = (f"{tuple(got.shape)} {got.dtype}"
                    if isinstance(got, torch.Tensor) else type(got).__name__)
            raise ValueError(f"{path}: checkpoint holds {desc}, template "
                             f"{tuple(want.shape)} {want.dtype}")
        if exact and not torch.equal(got, want):
            raise ValueError(f"{path}: values differ from the template")
    elif isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise ValueError(f"{path}: keys differ from the template")
        for k in want:
            check_like(got[k], want[k], exact, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            raise ValueError(f"{path}: length or kind differs from the "
                             f"template")
        for i, (a, b) in enumerate(zip(got, want)):
            check_like(a, b, exact, f"{path}/{i}")
    elif dataclasses.is_dataclass(want):
        if type(got) is not type(want):
            raise ValueError(f"{path}: checkpoint holds "
                             f"{type(got).__name__}, template "
                             f"{type(want).__name__}")
        for f in dataclasses.fields(want):
            check_like(getattr(got, f.name), getattr(want, f.name), exact,
                       f"{path}/{f.name}")
    elif got != want:
        raise ValueError(f"{path}: checkpoint holds {got!r}, template "
                         f"{want!r}")


def load_checkpoint(path: str, template: Any = None, device="cuda") -> Any:
    """Restore the tree saved at `path`, every tensor on `device`. With a
    `template` (a tree of the same structure, e.g. freshly initialised
    params), each tensor's shape and dtype and each static field must
    match it, else ValueError. The JAX package's `shardings` (placing
    leaves on a mesh) has no counterpart on one card."""
    tf = TensorFile(os.path.join(path, FILE_NAME))
    tree = _decode(json.loads(tf.metadata[_STRUCTURE_KEY]), tf, device)
    if template is not None:
        check_like(tree, template)
    return tree
