"""Fault-tolerant checkpoints (port of ``repro.checkpoint.manager``): atomic
commit, garbage collection, restore by leaf path.

Layout per step, the reference's file format (each package reads the
other's checkpoints)::

    <dir>/step_000000123.tmp/   (written)
        manifest.json           leaf paths, kinds and files; the plan
        arr_000000.npy ...      one file per array leaf, two per SlicedTensor
    <dir>/step_000000123/       (atomic rename = commit marker)

* A checkpoint is visible once its directory has no ``.tmp`` suffix: a
  crash mid-write leaves an uncommitted ``.tmp`` that ``restore_latest``
  ignores and the next save collects. A save of a step that is already
  committed keeps the first commit. ``keep_last`` bounds the disk used.
* Leaf paths are the reference's: '/'-joined dict keys, list indices and
  NamedTuple field names (``step``, ``digital/...``, ``sliced/...``,
  ``rng``), in ``jax.tree.flatten``'s order. Restore matches leaves by
  path, so reordered or added keys restore, and falls back to the legacy
  positional walk for manifests without paths. Path matching carries the
  MLA ``wq`` + ``w_dkv`` -> ``wq_dkv`` key migration (``_fuse_wq_dkv``).
* A stacked ``SlicedTensor`` is stored by the port as ``[*stack, S, M, N]``
  and viewed ``[S, *stack, M, N]``; the file holds the reference's ``[S,
  *stack, M, N]``. Saving writes the planes in file order one ``[M, N]``
  block at a time, each copied off the card into one pinned host block and
  written with a plain sequential ``write`` (a memmap of the file would
  fault in every 4 KiB page); restoring reads them back the same way with
  ``readinto``. Neither makes a copy of a whole leaf
  on the card or on the host. As in the reference, a save returns once the
  files are written and renamed, not synced to the disk.
* The port's host values: ``TrainState.step`` (an int) is stored as a 0-d
  int32 array and its ``rng`` (two key words) as one uint32 ``[2]`` array at
  path ``rng``, as the reference stores its own; both come back as the
  template's host types. bf16 leaves are refused by name (numpy has no
  bfloat16 without the ``ml_dtypes`` package).
* On a mesh (``mesh=``, ``specs=`` the state's spec tree,
  ``train.step.train_state_specs``), a save gathers the whole leaves from
  every rank's blocks and rank 0 writes them in the format above; a restore
  reads the whole leaves on every rank and keeps this rank's blocks
  (``train.step.shard_state``). So a checkpoint saved on one mesh restores
  on another, or on one process, and the other way round: an elastic
  restore.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.slicing import SliceSpec, slice_weights
from repro_torch.device import resolve
from repro_torch.optim.panther import SlicedTensor

_SLICED_TAG = "__sliced_tensor__"
_NONE_TAG = "__none__"


# --------------------------------- trees ------------------------------------


def _children(node):
    """An inner node's ``(key, child)`` pairs in ``jax.tree.flatten``'s order
    (dict keys sorted), or None for a leaf. ``None``, a ``SlicedTensor`` and
    a plain tuple (the rng words) are leaves; NamedTuples are nodes."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, list):
        return list(enumerate(node))
    if isinstance(node, tuple) and hasattr(node, "_fields") and not isinstance(node, SlicedTensor):
        return [(f, getattr(node, f)) for f in node._fields]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]``, paths as the reference's ``path_str`` writes
    them."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for k, v in kids for pl in _flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    kids = _children(template)
    if kids is None:
        return next(leaves)
    vals = {k: _unflatten(v, leaves) for k, v in kids}
    if isinstance(template, dict):
        return {k: vals[k] for k in template}
    if isinstance(template, list):
        return [vals[i] for i in range(len(template))]
    return type(template)(**vals)


# ------------------------------ leaf storage --------------------------------


def _blocks(planes_shape):
    """``(S, L, M, N)``: a planes shape ``[S, *stack, M, N]`` as S planes of
    L ``[M, N]`` blocks."""
    S, M, N = planes_shape[0], planes_shape[-2], planes_shape[-1]
    return S, int(np.prod(planes_shape[1:-2], dtype=np.int64)), M, N


def _staging(like: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """A host block for one ``[M, N]`` plane block, pinned when the planes
    live on a card (a direct DMA, with no staging copy in between)."""
    return torch.empty((M, N), dtype=torch.int8, pin_memory=like.is_cuda)


def _save_planes(path: str, planes: torch.Tensor) -> None:
    """Planes viewed ``[S, *stack, M, N]`` into an ``.npy`` of that shape,
    written in file order one ``[M, N]`` block at a time through a host
    block (the port's storage ``[*stack, S, M, N]`` makes each block
    contiguous on the card)."""
    if planes.dim() < 3:
        np.save(path, planes.cpu().numpy())
        return
    S, L, M, N = _blocks(planes.shape)
    src = planes.movedim(0, -3).reshape(L, S, M, N)
    buf = _staging(planes, M, N)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {"descr": np.dtype(np.int8).str, "fortran_order": False,
                                                 "shape": tuple(planes.shape)})
        for s in range(S):
            for l in range(L):
                buf.copy_(src[l, s])
                f.write(buf.numpy().data)


def _read_planes(path: str, device) -> torch.Tensor:
    """An ``.npy`` of int8 planes ``[S, *stack, M, N]`` into the port's
    storage ``[*stack, S, M, N]`` on ``device``, read in file order one
    ``[M, N]`` block at a time; returns the ``[S, *stack, M, N]`` view."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read_header = np.lib.format.read_array_header_1_0 if version == (1, 0) else \
            np.lib.format.read_array_header_2_0
        shape, fortran, dtype = read_header(f)
        if len(shape) < 3 or fortran or dtype != np.int8:
            f.seek(0)
            return _planes_to_device(np.load(f), device)
        S, L, M, N = _blocks(shape)
        lead = len(shape) - 3
        store = torch.empty((*shape[1:1 + lead], S, M, N), dtype=torch.int8, device=device)
        dst = store.view(L, S, M, N)
        buf = _staging(store, M, N)
        for s in range(S):
            for l in range(L):
                if f.readinto(buf.numpy().data) != M * N:
                    raise ValueError(f"{path}: truncated at plane {s}, block {l}")
                dst[l, s].copy_(buf)
    return store.movedim(lead, 0)


def _planes_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Planes held in host memory ``[S, *stack, M, N]`` into the port's
    storage on ``device``; returns the ``[S, *stack, M, N]`` view."""
    if arr.ndim < 3:
        return torch.from_numpy(np.array(arr)).to(device)
    lead = arr.ndim - 3
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(arr, 0, lead))).to(device).movedim(lead, 0)


def _host_array(path: str, leaf) -> np.ndarray:
    """A non-sliced leaf as the numpy array the file holds."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"checkpoint leaf {path!r} is bf16: numpy has no bfloat16 without the ml_dtypes "
                             "package, so this format cannot hold it")
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):  # a host step
        return np.asarray(leaf, dtype=np.int32)
    if isinstance(leaf, tuple):  # a host rng key: its words
        return np.asarray(leaf, dtype=np.uint32)
    return np.asarray(leaf)


def _to_template(arr: np.ndarray, tmpl, device):
    """A stored array as the template leaf's type: a host int, a tuple of
    key words, or a tensor on ``device``."""
    if isinstance(tmpl, int):
        return int(arr)
    if isinstance(tmpl, tuple):
        return tuple(int(w) for w in np.asarray(arr).reshape(-1))
    return torch.from_numpy(np.array(arr)).to(device)


# ------------------------------- save / list --------------------------------


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def save_checkpoint(directory: str, step: int, tree, keep_last: int = 3, plan=None, mesh=None, specs=None) -> str:
    """Commit ``tree`` as ``step``; returns the committed directory.
    ``plan``: the resolved plan, persisted (``plan.plan_manifest``) so that a
    restore can check the stored layout against its own plan. ``mesh`` /
    ``specs``: ``tree`` is this rank's blocks of a ``TrainState`` (module
    docstring); every rank calls this, rank 0 writes."""
    if mesh is not None and mesh.live:
        import torch.distributed as dist

        from repro_torch.train.step import gather_state

        tree = gather_state(tree, specs, mesh)
        if dist.get_rank() == 0:
            save_checkpoint(directory, step, tree, keep_last, plan)
        del tree
        dist.barrier()
        return _step_dir(directory, step)
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    name = os.path.basename(final)
    if not os.path.exists(final):  # a re-save of a committed step (restart replay) keeps the first commit
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "treedef": f"repro_torch {type(tree).__name__}"}
        if plan is not None:
            from repro_torch.plan import plan_manifest

            manifest["plan"] = plan_manifest(plan)
        idx = 0
        for ps, leaf in _flatten_with_paths(tree):
            if leaf is None:
                manifest["leaves"].append({"kind": _NONE_TAG, "path": ps})
            elif isinstance(leaf, SlicedTensor):
                _save_planes(os.path.join(tmp, f"arr_{idx:06d}.npy"), leaf.planes)
                np.save(os.path.join(tmp, f"arr_{idx + 1:06d}.npy"),
                        np.asarray(torch.as_tensor(leaf.frac_bits).cpu().numpy(), dtype=np.int32))
                manifest["leaves"].append({"kind": _SLICED_TAG, "files": [idx, idx + 1], "path": ps})
                idx += 2
            else:
                np.save(os.path.join(tmp, f"arr_{idx:06d}.npy"), _host_array(ps, leaf))
                manifest["leaves"].append({"kind": "array", "files": [idx], "path": ps})
                idx += 1
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)  # atomic commit

    # GC: old commits and stale tmp directories
    entries = sorted(e for e in os.listdir(directory) if e.startswith("step_"))
    commits = [e for e in entries if not e.endswith(".tmp")]
    for stale in [e for e in entries if e.endswith(".tmp") and e != name + ".tmp"]:
        shutil.rmtree(os.path.join(directory, stale), ignore_errors=True)
    for old in commits[:-keep_last]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)
    return final


def list_checkpoints(directory: str) -> list:
    """The committed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return [int(e.split("_")[1]) for e in sorted(os.listdir(directory))
            if e.startswith("step_") and not e.endswith(".tmp")
            and os.path.exists(os.path.join(directory, e, "manifest.json"))]


# --------------------------------- restore ----------------------------------


def _unslice_i64(planes: np.ndarray) -> np.ndarray:
    """Digit planes ``[S, ...]`` as int64 logical values, exact for dirty
    (carry-laden) planes too (up to ~2.3e9: past int32, not int64)."""
    return sum(planes[s].astype(np.int64) * 16**s for s in range(planes.shape[0]))


def _fuse_wq_dkv(a, b):
    """Key migration: separate MLA ``wq`` / ``w_dkv`` leaves -> the fused
    ``wq_dkv`` ``[..., d, q_dim + rank + rope]`` layout (``[q | dkv]``).
    ``a``, ``b``: numpy arrays, or ``(planes, frac_bits)`` pairs of numpy
    arrays for sliced leaves.

    Float leaves concatenate exactly. Sliced leaves carry per-tensor grids,
    so the halves move onto a shared grid in integer arithmetic (int64
    reassembly, a power-of-two rescale in f64: exact below 2^53). The shared
    ``frac_bits`` starts at ``max(F_a, F_b)`` and backs off only while a
    rescaled value would leave the canonical digit range; values that still
    do not fit at ``min(F_a, F_b)`` rail at ±canonical_limit, as a CRS
    overflow does. Returns a numpy array, or ``(planes [S, ...], frac_bits)``.
    """
    if not isinstance(a, tuple):
        return np.concatenate([a, b], axis=-1)
    (pa, fa), (pb, fb) = a, b
    spec = SliceSpec.uniform(4, n_slices=pa.shape[0])  # canonical digits only
    va, vb = _unslice_i64(pa).astype(np.float64), _unslice_i64(pb).astype(np.float64)
    fa, fb = int(fa), int(fb)
    lim = spec.canonical_limit
    f = max(fa, fb)
    while f > min(fa, fb) and max(np.abs(va).max() * 2.0 ** (f - fa), np.abs(vb).max() * 2.0 ** (f - fb)) > lim:
        f -= 1
    cat = np.concatenate([np.rint(va * 2.0 ** (f - fa)), np.rint(vb * 2.0 ** (f - fb))], axis=-1)
    cat = np.clip(cat, -lim, lim).astype(np.int32)
    return slice_weights(torch.from_numpy(cat), spec).numpy(), np.asarray(f, dtype=np.int32)


def restore_latest(directory: str, template, device=None, plan=None, mesh=None, specs=None):
    """Restore the newest committed checkpoint into ``template``'s structure;
    returns ``(tree, step)``, or ``(None, -1)`` when there is none.

    Tensors go to ``device`` (resolved as everywhere in the port), or to the
    device of the template's leaf, or of its first tensor. ``plan``: the
    restoring job's resolved plan; when the manifest has one too, the stored
    layout and write physics are checked against it path by path
    (``plan.check_plan_compat``) before any leaf loads. ``mesh`` /
    ``specs``: the whole ``TrainState`` is read and this rank's blocks of it
    returned (module docstring).
    """
    if mesh is not None and mesh.live:
        from repro_torch.train.step import shard_state

        whole, step = restore_latest(directory, template, device=device, plan=plan)
        return (None, step) if whole is None else (shard_state(whole, specs, mesh), step)
    steps = list_checkpoints(directory)
    if not steps:
        return None, -1
    step = steps[-1]
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if plan is not None and manifest.get("plan"):
        from repro_torch.plan import check_plan_compat

        check_plan_compat(manifest["plan"], plan, context=f"checkpoint step {step}")

    t_leaves = _flatten_with_paths(template)
    if device is not None:
        default = resolve(device)
    else:
        devs = [(x.planes if isinstance(x, SlicedTensor) else x).device for _, x in t_leaves
                if isinstance(x, (torch.Tensor, SlicedTensor))]
        default = devs[0] if devs else resolve(None)

    def where(tmpl):
        if device is None and isinstance(tmpl, (torch.Tensor, SlicedTensor)):
            return (tmpl.planes if isinstance(tmpl, SlicedTensor) else tmpl).device
        return default

    def load(meta, k=0):
        arr = np.load(os.path.join(path, f"arr_{meta['files'][k]:06d}.npy"), mmap_mode="r")
        if arr.dtype.kind == "V":
            raise ValueError(f"checkpoint step {step}: leaf {meta.get('path', meta['files'][k])!r} holds "
                             f"{arr.dtype} (bf16?), which numpy cannot read without the ml_dtypes package")
        return arr

    def raw(meta):
        """A stored leaf as numpy: an array, or (planes, frac_bits)."""
        return (load(meta), load(meta, 1)) if meta["kind"] == _SLICED_TAG else load(meta)

    def sliced(planes, frac, dev):
        return SlicedTensor(planes=planes, frac_bits=torch.from_numpy(np.array(frac, dtype=np.int32)).to(dev))

    def materialize(meta, tmpl, migrated=None):
        dev = where(tmpl)
        if migrated is not None:  # a key migration's numpy result
            return sliced(_planes_to_device(migrated[0], dev), migrated[1], dev) if isinstance(migrated, tuple) \
                else _to_template(migrated, tmpl, dev)
        if meta["kind"] == _NONE_TAG:
            return None
        if meta["kind"] == _SLICED_TAG:
            return sliced(_read_planes(os.path.join(path, f"arr_{meta['files'][0]:06d}.npy"), dev),
                          load(meta, 1), dev)
        return _to_template(load(meta), tmpl, dev)

    metas = manifest["leaves"]
    by_path = {m["path"]: m for m in metas if "path" in m}
    if len(by_path) == len(metas):
        out = []
        for ps, tmpl in t_leaves:
            meta = by_path.get(ps)
            if meta is not None:
                out.append(materialize(meta, tmpl))
                continue
            if ps.endswith("wq_dkv"):
                mq, md = by_path.get(ps[: -len("wq_dkv")] + "wq"), by_path.get(ps[: -len("wq_dkv")] + "w_dkv")
                if mq is not None and md is not None:
                    out.append(materialize(mq, tmpl, _fuse_wq_dkv(raw(mq), raw(md))))
                    continue
            raise KeyError(f"checkpoint at step {step} has no leaf for template path '{ps}' and no known "
                           "migration applies")
        return _unflatten(template, iter(out)), step

    # legacy manifest (no paths): positional restore
    if len(metas) != len(t_leaves):
        raise ValueError(
            f"legacy (pre-path) checkpoint at step {step} has {len(metas)} leaves but the template has "
            f"{len(t_leaves)}: a positional restore cannot migrate renamed keys; re-save this checkpoint once "
            "with the code version that wrote it to stamp leaf paths, then restore here")
    return _unflatten(template, iter(materialize(m, tmpl) for m, (_, tmpl) in zip(metas, t_leaves))), step


class CheckpointManager:
    """Save every ``every`` steps, keep the last ``keep_last`` commits, and
    persist and check ``plan`` (a resolved plan) with every save and
    restore; on a mesh (``mesh``, ``specs``) save and restore whole leaves
    from and into this rank's blocks."""

    def __init__(self, directory: str, every: int = 100, keep_last: int = 3, plan=None, mesh=None, specs=None):
        self.directory = directory
        self.every = every
        self.keep_last = keep_last
        self.plan = plan
        self.mesh, self.specs = mesh, specs

    def maybe_save(self, step: int, tree) -> str | None:
        if step % self.every == 0 and step > 0:
            return save_checkpoint(self.directory, step, tree, self.keep_last, plan=self.plan, mesh=self.mesh,
                                   specs=self.specs)
        return None

    def restore(self, template, device=None):
        return restore_latest(self.directory, template, device=device, plan=self.plan, mesh=self.mesh,
                              specs=self.specs)
