"""Checkpointing: a tree of arrays <-> ``.npz`` with structural keys and a
typed manifest, in the JAX package's on-disk format.

A file holds one array per leaf, keyed by the leaf's path as the JAX
package writes it (``jax.tree_util.keystr`` of each path element, joined
by ``"|"``): ``['u']`` for a dict key, ``[0]`` for a list or tuple
index, ``.name`` for a NamedTuple field, so ``['z']|['y']|[0]``. Dict
keys are visited in sorted order and ``None`` is an empty subtree, as in
``jax.tree.flatten``. The ``CkptManifest`` sits beside the leaves under
``"__manifest__"`` as the uint8 bytes of its JSON. A checkpoint written
by either package restores in the other.

Leaves may be numpy arrays, torch tensors (any device) or Python scalars;
``restore`` returns numpy arrays in the structure of ``like``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Any, Optional

import numpy as np
import torch

_SEP = "|"
_MANIFEST_KEY = "__manifest__"
_LEGACY_KEY = "__metadata__"

MANIFEST_VERSION = 2

# Fields a manifest declares (everything else rides in ``extra``).
_FIELDS = ("kind", "arch", "n_clients", "n_clusters", "plane_shape",
           "pack_digest", "codec", "qblock")


@dataclasses.dataclass(frozen=True)
class CkptManifest:
    """Typed checkpoint sidecar. ``None`` means "writer did not declare
    it": readers that depend on a field call ``need(...)`` and get an
    error naming it, not a silent default."""

    kind: str = "checkpoint"            # "checkpoint" | "servable" | ...
    arch: Optional[str] = None          # model registry name
    n_clients: Optional[int] = None     # N
    n_clusters: Optional[int] = None    # S
    plane_shape: Optional[tuple] = None  # packed plane dims, e.g. (S, X)
    pack_digest: Optional[str] = None   # PackSpec.digest of the layout
    codec: str = "fp32"                 # wire codec of stored plane
    qblock: Optional[int] = None        # quantization block (quant codecs)
    version: int = MANIFEST_VERSION
    extra: dict = dataclasses.field(default_factory=dict)

    def need(self, *fields: str) -> "CkptManifest":
        """Assert the named fields were declared by the writer; the error
        names every missing one."""
        missing = [f for f in fields if getattr(self, f, None) is None]
        if missing:
            raise KeyError(
                "checkpoint manifest missing required field(s) "
                f"{missing} (kind={self.kind!r}); re-export with a writer "
                "that declares them")
        return self

    def check(self, **expected: Any) -> "CkptManifest":
        """Assert declared fields match ``expected`` exactly; mismatches
        are reported per field with both values."""
        bad = []
        for f, want in expected.items():
            got = getattr(self, f)
            if isinstance(got, tuple) or isinstance(want, (tuple, list)):
                got, want = tuple(got or ()), tuple(want or ())
            if got != want:
                bad.append(f"{f}: manifest {got!r} != expected {want!r}")
        if bad:
            raise ValueError("checkpoint manifest mismatch — " + "; ".join(bad))
        return self

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["plane_shape"] is not None:
            d["plane_shape"] = list(d["plane_shape"])
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: str) -> "CkptManifest":
        d = json.loads(raw)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = {k: d.pop(k) for k in list(d) if k not in known}
        if d.get("plane_shape") is not None:
            d["plane_shape"] = tuple(d["plane_shape"])
        if unknown:
            d.setdefault("extra", {}).update(unknown)
        return cls(**d)

    @classmethod
    def from_legacy(cls, meta: dict) -> "CkptManifest":
        """Upconvert a v1 free-form metadata dict: recognized keys become
        declared fields, the rest lands in ``extra`` verbatim."""
        meta = dict(meta)
        kw: dict[str, Any] = {"version": 1}
        for f in _FIELDS:
            if f in meta:
                kw[f] = meta.pop(f)
        if kw.get("plane_shape") is not None:
            kw["plane_shape"] = tuple(kw["plane_shape"])
        kw["extra"] = meta
        return cls(**kw)


def _children(node) -> Optional[list]:
    """(key string, child) pairs of an inner node in ``jax.tree.flatten``
    order, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):   # NamedTuple
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) for every leaf of ``tree``, keys as the JAX package
    writes them."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(_SEP.join(prefix), tree)]
    out = []
    for k, v in kids:
        out.extend(_paths(v, prefix + (k,)))
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree, manifest: CkptManifest | None = None,
         metadata: dict | None = None) -> None:
    """Atomic save of a tree (+ manifest) to ``path`` (.npz).

    ``metadata=`` (the v1 loose-dict sidecar) still works but warns; the
    dict is upconverted through ``CkptManifest.from_legacy``."""
    if metadata is not None:
        warnings.warn(
            "ckpt.save(metadata=...) is deprecated; pass "
            "manifest=CkptManifest(...) instead",
            DeprecationWarning, stacklevel=2)
        if manifest is not None:
            raise ValueError("pass manifest= or metadata=, not both")
        manifest = dataclasses.replace(
            CkptManifest.from_legacy(metadata), version=MANIFEST_VERSION)
    manifest = manifest or CkptManifest()
    arrays = {key: _numpy(leaf) for key, leaf in _paths(tree)}
    raw = manifest.to_json().encode()
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{_MANIFEST_KEY: np.frombuffer(raw, dtype=np.uint8)},
                     **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_manifest(data) -> CkptManifest:
    if _MANIFEST_KEY in data:
        return CkptManifest.from_json(data[_MANIFEST_KEY].tobytes().decode())
    if _LEGACY_KEY in data:
        warnings.warn(
            "loading legacy __metadata__ JSON-blob checkpoint; re-save "
            "with the CkptManifest writer (support lasts one release)",
            DeprecationWarning, stacklevel=3)
        return CkptManifest.from_legacy(
            json.loads(data[_LEGACY_KEY].tobytes().decode()))
    return CkptManifest(version=1)


def read_manifest(path: str) -> CkptManifest:
    """Peek at a checkpoint's manifest without loading the arrays."""
    with np.load(path) as data:
        return _load_manifest(data)


def _rebuild(like, arrays: dict, prefix: tuple = ()):
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        key = _SEP.join(prefix)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        want = _numpy(like)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(
                f"shape mismatch for {key!r}: ckpt {arr.shape} vs model "
                f"{want.shape}")
        return arr.astype(want.dtype)
    vals = [_rebuild(v, arrays, prefix + (k,)) for k, v in kids]
    if isinstance(like, dict):
        return {k: v for k, v in zip(sorted(like), vals)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def restore(path: str, like) -> tuple[Any, CkptManifest]:
    """Restore into the structure of ``like`` (shapes validated, dtypes
    cast to ``like``'s), as numpy arrays."""
    with np.load(path) as data:
        manifest = _load_manifest(data)
        return _rebuild(like, data), manifest


def latest(dirpath: str, prefix: str = "ckpt_") -> str | None:
    if not os.path.isdir(dirpath):
        return None
    cands = [f for f in os.listdir(dirpath)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix):-4]))
    return os.path.join(dirpath, cands[-1])
