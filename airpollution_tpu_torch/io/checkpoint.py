"""Checkpoint and resume for PINN training and CRBE fields, PyTorch
counterpart of ``airpollution_tpu/io/checkpoint.py`` (without its orbax
path).

- :func:`save_pytree` / :func:`load_pytree` store a nest of lists, tuples,
  NamedTuples and dicts of tensors or arrays as a ``.npz`` of its leaves
  (``leaf_0``, ``leaf_1``, ... in the JAX package's flatten order: dict
  keys sorted) beside a ``.tree`` descriptor in the JAX package's
  ``PyTreeDef(...)`` form; both writes are atomic (write, then rename).
  A network's parameters are saved in the JAX package's layout
  (``PINN.params``), so a ``pinn_*.npz`` of either package loads into the
  other's model of the same shape; so does an FNO's ``FNOParams``
  (models/fno.py), a NamedTuple, whose descriptor is JAX's
  ``CustomNode(namedtuple[FNOParams], [...])``.
- :func:`save_pinn` / :func:`load_pinn` keep the parameters, the training
  carry (``PINN.train(warm_start=True)`` continues from it) and the
  metadata; :func:`train_with_checkpoints` trains in chunks with a
  checkpoint after each and resumes from the last one.
- :func:`save_field` / :func:`load_field` store a solution field.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree):
    """(leaves, descriptor) of a nest of lists, tuples and dicts; ``None``
    is a structure node with no leaf, as in JAX."""
    leaves = []

    def walk(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in keys) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            # A NamedTuple (models/fno.FNOParams): JAX's custom node.
            inner = ", ".join(walk(v) for v in node)
            return (f"CustomNode(namedtuple[{type(node).__name__}], "
                    f"[{inner}])")
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(v) for v in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _atomic_write_text(path: str, text: str) -> None:
    """Write, then rename, so that a crash mid-write never truncates
    ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def save_pytree(path: str, tree) -> None:
    """Save a nest of tensors or arrays as a .npz plus a structure
    descriptor, each written atomically; a mismatched pair left by a crash
    between the two renames is refused by :func:`load_pytree`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, descriptor = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    tmp = path + ".tmp.npz"  # np.savez appends .npz to bare names
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    _atomic_write_text(path + ".tree", descriptor)


def read_pytree(path: str):
    """(numpy leaves, descriptor or None) of a file of
    :func:`save_pytree`, or of the JAX package's ``save_pytree``."""
    data = np.load(path)
    n = len([k for k in data.files if k.startswith("leaf_")])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    tree_path = path + ".tree"
    descriptor = None
    if os.path.exists(tree_path):
        with open(tree_path) as f:
            descriptor = f.read()
    return leaves, descriptor


def load_pytree(path: str, like):
    """Load a file of :func:`save_pytree` into the structure of ``like``:
    a tensor leaf of ``like`` gets a tensor of its dtype and device, any
    other leaf a numpy array. The descriptor, the leaf count and each
    shape must match ``like``'s (ValueError otherwise)."""
    leaves, saved = read_pytree(path)
    flat_like, descriptor = _flatten(like)
    if saved is not None and saved != descriptor:
        raise ValueError(
            f"checkpoint structure mismatch: {path} was saved with a "
            "different pytree structure than the target")
    if len(leaves) != len(flat_like):
        raise ValueError(
            f"checkpoint leaf count mismatch: {path} holds {len(leaves)} "
            f"leaves but the target expects {len(flat_like)}")
    out = []
    for i, (value, target) in enumerate(zip(leaves, flat_like)):
        if tuple(value.shape) != tuple(np.shape(_numpy(target))):
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(value.shape)} but the "
                f"target expects {tuple(np.shape(_numpy(target)))} — the "
                "checkpoint was saved from a different model size")
        if isinstance(target, torch.Tensor):
            value = torch.as_tensor(value).to(dtype=target.dtype,
                                              device=target.device)
        out.append(value)
    return _unflatten(like, out)


def params_from_descriptor(path: str):
    """The JAX-layout parameter list (list of dicts of numpy arrays) of a
    ``pinn_*.npz`` params file of either package, rebuilt from its
    ``.tree`` descriptor."""
    leaves, descriptor = read_pytree(path)
    if descriptor is None:
        raise ValueError(f"{path} has no .tree descriptor beside it")
    body = descriptor.strip()
    if not (body.startswith("PyTreeDef([{") and body.endswith("}])")):
        raise ValueError(f"{path}.tree is not a list of dicts: {body}")
    layers = []
    it = iter(leaves)
    for chunk in body[len("PyTreeDef(["):-len("])")].split("}, {"):
        keys = [k.split(":")[0].strip().strip("{}'\" ")
                for k in chunk.split(",")]
        layers.append({k: next(it) for k in keys})
    return layers


def _carry_tree(model):
    return {k: model._carry_state[k] for k in sorted(model._carry_state)}


def save_pinn(ckpt_dir: str, model, step: int | None = None, *,
              epoch: int | None = None) -> str:
    """Checkpoint a PINN: parameters, training carry and metadata.
    ``step`` selects the file tag (None: the rolling "latest" set);
    ``epoch`` records the resume point in the same atomic metadata
    write."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = f"step_{step}" if step is not None else "latest"
    path = os.path.join(ckpt_dir, f"pinn_{tag}.npz")
    save_pytree(path, model.params)
    if model._carry_state is not None:
        save_pytree(os.path.join(ckpt_dir, f"carry_{tag}.npz"),
                    _carry_tree(model))
    meta = {
        "layers": model.layers,
        "activation": model.activation,
        "step": epoch if epoch is not None else step,
        "history_len": len(model.history["total_loss"]),
    }
    _atomic_write_text(os.path.join(ckpt_dir, f"meta_{tag}.json"),
                       json.dumps(meta))
    return path


def load_pinn(ckpt_dir: str, model, step: int | None = None):
    """Restore the parameters (and the training carry, where the model has
    one to fill and the file exists) into ``model``."""
    tag = f"step_{step}" if step is not None else "latest"
    path = os.path.join(ckpt_dir, f"pinn_{tag}.npz")
    model.params = load_pytree(path, model.params)
    carry_path = os.path.join(ckpt_dir, f"carry_{tag}.npz")
    if model._carry_state is not None and os.path.exists(carry_path):
        loaded = load_pytree(carry_path, _carry_tree(model))
        loaded["step"] = int(loaded["step"])
        model._carry_state = loaded
    return model


def save_field(path: str, solutions, times=None) -> None:
    """Store a space-time field (and optionally its time grid)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"solutions": _numpy(solutions)}
    if times is not None:
        payload["times"] = _numpy(times)
    np.savez(path, **payload)


def load_field(path: str):
    data = np.load(path)
    times = data["times"] if "times" in data else None
    return data["solutions"], times


def read_meta(ckpt_dir: str, step: int | None = None) -> dict | None:
    tag = f"step_{step}" if step is not None else "latest"
    path = os.path.join(ckpt_dir, f"meta_{tag}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def train_with_checkpoints(model, batch_sizes, epochs, lr, lambda_weights,
                           ckpt_dir, checkpoint_every=500, resume=True,
                           **train_kwargs):
    """Train a PINN in ``checkpoint_every``-epoch chunks under
    ``warm_start``, saving parameters and carry after each; with
    ``resume`` a restart loads the latest checkpoint and continues from
    its recorded epoch."""
    start_epoch = 0
    meta = read_meta(ckpt_dir) if resume else None
    if meta is not None:
        # Materialize the carry structure, then restore into it.
        model.train(batch_sizes, 0, lr, lambda_weights, **train_kwargs)
        load_pinn(ckpt_dir, model)
        start_epoch = int(meta.get("step") or 0)
        print(f"Resumed from {ckpt_dir} at epoch {start_epoch}")

    done = start_epoch
    while done < epochs:
        chunk = min(checkpoint_every, epochs - done)
        model.train(batch_sizes, chunk, lr, lambda_weights,
                    warm_start=(done > 0), **train_kwargs)
        done += chunk
        save_pinn(ckpt_dir, model, step=None, epoch=done)
    return model.history
