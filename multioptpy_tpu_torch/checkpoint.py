"""Checkpoint and resume for driver states.

Counterpart of `multioptpy_tpu/checkpoint.py`, in the port's own format: one
npz file holding every tensor leaf as a numpy array plus a JSON manifest of
the tree (NamedTuples by class name, tuples, lists, dicts). No pickle. A
`torch.Generator` leaf (the RL stepper's draw stream) is stored as its
state bytes and rebuilt on the loading device. Tensors come back on the
device the caller names, the CUDA card unless asked for the CPU.
"""

import json

import numpy as np
import torch

from multioptpy_tpu_torch.device import resolve_device

_NAMEDTUPLES = {}


def register_state_type(cls):
    """Register a NamedTuple state class for reconstruction on load."""
    _NAMEDTUPLES[cls.__name__] = cls
    return cls


def state_types():
    """Every NamedTuple state class of the drivers and steppers, by name."""
    from multioptpy_tpu_torch.drivers.optimize import OptState
    from multioptpy_tpu_torch.hessian.block_updates import BlockWindow
    from multioptpy_tpu_torch.steppers import (diis, first_order, gp,
                                               learned, ml)
    for cls in (OptState, BlockWindow, first_order.FireState,
                first_order.CgState, first_order.LbfgsState, diis.DiisState,
                diis.GediisState, diis.KdiisState, gp.GpState,
                learned.GanState, learned.RlState, ml.OptaxState,
                ml.EveState):
        _NAMEDTUPLES.setdefault(cls.__name__, cls)
    return _NAMEDTUPLES


def save_checkpoint(path, state, meta=None):
    """state: a tree of tensors (NamedTuples, tuples, lists, dicts,
    generators). meta: a JSON-serializable dict."""
    arrays = {}

    def enc(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {"__namedtuple__": type(node).__name__,
                    "fields": {f: enc(getattr(node, f))
                               for f in node._fields}}
        if isinstance(node, (list, tuple)):
            return {"__seq__": "tuple" if isinstance(node, tuple) else "list",
                    "items": [enc(x) for x in node]}
        if isinstance(node, dict):
            return {"__dict__": {k: enc(v) for k, v in node.items()}}
        key = f"leaf_{len(arrays)}"
        if isinstance(node, torch.Generator):
            arrays[key] = node.get_state().numpy()
            return {"__generator__": key}
        arrays[key] = (node.detach().cpu().numpy()
                       if isinstance(node, torch.Tensor) else np.asarray(node))
        return {"__leaf__": key}

    manifest = json.dumps({"tree": enc(state), "meta": meta or {}})
    with open(path, "wb") as f:
        np.savez(f, __manifest__=manifest, **arrays)


def load_checkpoint(path, device=None):
    """-> (state, meta), tensors on `device` (None means the CUDA card).
    NamedTuple nodes are rebuilt from the registered classes."""
    device = resolve_device(device)
    types = state_types()
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}

    def dec(node):
        if "__leaf__" in node:
            return torch.as_tensor(arrays[node["__leaf__"]], device=device)
        if "__generator__" in node:
            gen = torch.Generator(device=device)
            gen.set_state(torch.as_tensor(arrays[node["__generator__"]]))
            return gen
        if "__namedtuple__" in node:
            vals = {k: dec(v) for k, v in node["fields"].items()}
            cls = types.get(node["__namedtuple__"])
            return vals if cls is None else cls(**vals)
        if "__seq__" in node:
            items = [dec(x) for x in node["items"]]
            return tuple(items) if node["__seq__"] == "tuple" else items
        if "__dict__" in node:
            return {k: dec(v) for k, v in node["__dict__"].items()}
        raise ValueError("bad manifest node")

    return dec(manifest["tree"]), manifest["meta"]
