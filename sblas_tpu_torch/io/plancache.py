"""Plan serialization: save and load any plan as a portable .npz.

Port of `sblas_tpu/io/plancache.py`.  Plans are analysis-heavy (the
routed engine colours an nnz-edge multigraph at build time: seconds at a
million rows) and immutable, so they are built once and kept
(cuSPARSE's `*_analysis`, FFTW's wisdom).  The reference re-analyses on
every run (matrix.h:341-395).

Covers the six single-device plans, the distributed containers
(`RowPlanShards`, `HaloDiaShards`, `XFootShards`, with `XFootPlan`) and
the host-resident ones (`HostResidentPlan`, `HostResidentShards`) by a
recursive walk of the dataclass fields: nested plans, lists of per-band
plans, tuples of per-shard plans (None where a rank does not hold a
shard), tensors, numpy arrays, tuples of tensors and the `XFootStats`
NamedTuple round-trip.  Residency state (underscore fields: device
copies, streams) is not saved: a loaded host-resident plan starts
untuned, its bands in host memory, pinned when its device is CUDA.

Format (the JAX package's): one .npz holding the dataclass fields, tensors
as arrays (`a:` tensors, `n:` numpy arrays, `t:<field>:<i>` tuples of
tensors, dotted and indexed key prefixes for nested objects), the other
fields as one JSON blob with the arrays' dtypes recorded.  No pickle, so
files are safe to share; a file written by `sblas_tpu`'s `save_plan` for
a `RoutedPlan` or a `WcooPlan` (or another plan whose fields match the
port's) loads here: a plan class's port-only fields (`PORT_FIELDS`)
missing from a file are derived by its `port_fields`.  Tensors load
through `put`, by default onto the `device` the caller names: there is
no implicit device, and a host-resident plan's bands load to the host
for that device.

A bf16-transport `RoutedPlan` (float32 values, int16 main-route tables)
round-trips like any other.  A plan with bfloat16 values cannot be
saved: numpy has no bfloat16, and the JAX package's `save_plan` writes
such values as raw 2-byte records (`|V2`) that its own `load_plan`
refuses, so `save_plan` raises `FormatError` rather than write a file no
package can load.
"""

from __future__ import annotations

import dataclasses
import io as iomod
import json
import os
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from ..utils.errors import FormatError, require


def _plan_registry():
    from ..memory.dist import HostResidentShards
    from ..memory.host import HostResidentPlan
    from ..ops.bsr import BsrPlan
    from ..ops.dia import DiaPlan
    from ..ops.plans import CooPlan, EllPlan
    from ..ops.rspmv import RoutedPlan
    from ..ops.wcoo import WcooPlan
    from ..parallel.planned import HaloDiaShards, RowPlanShards
    from ..parallel.xfoot import XFootPlan, XFootShards
    return {c.__name__: c for c in
            (BsrPlan, CooPlan, DiaPlan, EllPlan, RoutedPlan, WcooPlan,
             RowPlanShards, HaloDiaShards, XFootShards, XFootPlan,
             HostResidentPlan, HostResidentShards)}


def _namedtuple_registry():
    from ..parallel.xfoot import XFootStats
    return {c.__name__: c for c in (XFootStats,)}


def _tuplify(x: Any) -> Any:
    """JSON round trip: lists -> tuples, recursively (schedules and shapes
    are tuples and must hash)."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def _is_plan(v, registry) -> bool:
    return dataclasses.is_dataclass(v) and type(v).__name__ in registry


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("float64", "int32", ...)."""
    return str(dtype).replace("torch.", "")


def _host(key: str, t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array the file stores; bfloat16 raises."""
    require(t.dtype != torch.bfloat16, FormatError,
            f"save_plan: {key!r} holds bfloat16 values, which no plan file "
            f"can hold (numpy has no bfloat16; the JAX package writes them "
            f"as raw |V2 records its load_plan refuses, so neither package "
            f"could load the file): build bfloat16 plans at run time")
    return t.detach().cpu().numpy()


def _flatten(obj, prefix: str, arrays: dict, meta: dict, dtypes: dict,
             registry: dict) -> None:
    meta[f"{prefix}__class__"] = type(obj).__name__
    for f in dataclasses.fields(obj):
        if f.name.startswith("_"):
            continue
        v = getattr(obj, f.name)
        key = prefix + f.name
        if _is_plan(v, registry):
            _flatten(v, key + ".", arrays, meta, dtypes, registry)
        elif (isinstance(v, list) and v
              and all(_is_plan(e, registry) for e in v)):
            meta[f"__list__{key}"] = len(v)   # per-band plans
            for i, e in enumerate(v):
                _flatten(e, f"{key}[{i}].", arrays, meta, dtypes, registry)
        elif (isinstance(v, tuple) and v
              and all(e is None or _is_plan(e, registry) for e in v)
              and any(e is not None for e in v)):
            # per-shard plans; a None entry (a shard this rank does not
            # hold) is recorded by its missing class key
            meta[f"__shards__{key}"] = len(v)
            for i, e in enumerate(v):
                if e is not None:
                    _flatten(e, f"{key}[{i}].", arrays, meta, dtypes,
                             registry)
        elif isinstance(v, torch.Tensor):
            arrays[f"a:{key}"] = _host(key, v)
            dtypes[f"a:{key}"] = _dtype_name(v.dtype)
        elif isinstance(v, np.ndarray):
            arrays[f"n:{key}"] = v
        elif (isinstance(v, tuple) and v
              and all(isinstance(e, torch.Tensor) for e in v)):
            for i, e in enumerate(v):
                arrays[f"t:{key}:{i}"] = _host(key, e)
                dtypes[f"t:{key}:{i}"] = _dtype_name(e.dtype)
            meta[f"__tuplelen__{key}"] = len(v)
        elif (isinstance(v, tuple) and hasattr(v, "_fields")
              and type(v).__name__ in _namedtuple_registry()):
            meta[key] = list(v)
            meta[f"__nt__{key}"] = type(v).__name__
        else:
            meta[key] = v


def save_plan(path: str, plan) -> None:
    """Serialize a plan or a shard container to `path` (.npz, no pickle).
    The file appears whole or not at all (written aside, then renamed), so
    a reader on another rank never sees a partial one."""
    arrays: dict = {}
    meta: dict = {}
    dtypes: dict = {}
    _flatten(plan, "", arrays, meta, dtypes, _plan_registry())
    # intended dtypes recorded, so a load that would change one fails
    # loudly instead of silently converting
    meta["__dtypes__"] = dtypes
    buf = iomod.BytesIO()
    np.savez_compressed(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(buf.getvalue())
    os.replace(tmp, path)


def load_plan(path: str, device=None, *, put=None,
              rank: Optional[int] = None):
    """Load a plan saved by `save_plan` (or by `sblas_tpu`'s).

    Each tensor goes through `put(array)`; the default moves it onto
    `device`, and one of the two must be given.  `rank` keeps only that
    shard of a shard container (the others load as None), as the
    partitioners' `rank=` places them.  A host-resident plan's tensors
    load to the host (pinned when `device` is CUDA) and the plan computes
    on `device`.

    Raises FormatError when a loaded array's dtype differs from the one
    recorded at save time, and when the file does not match the current
    plan classes (schema drift): delete it and rebuild."""
    require(device is not None or put is not None, ValueError,
            "load_plan needs a device (or a put function)")
    if put is None:
        def put(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def host_put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr))

    def _dev(key, arr, want: Optional[str], put):
        out = put(arr)
        if want is not None and _dtype_name(out.dtype) != want:
            raise FormatError(
                f"plan cache {path}: array {key!r} was saved as {want} but "
                f"loads as {out.dtype}; re-save the plan")
        return out

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        dtypes = meta.pop("__dtypes__", {})
        registry = _plan_registry()
        nt_registry = _namedtuple_registry()
        files = set(z.files)

        def build(prefix: str, put=put):
            cls = registry[meta[f"{prefix}__class__"]]
            resident = getattr(cls, "HOST_RESIDENT", False)
            if resident:
                put = host_put   # its bands stay on the host
            kwargs = {}
            # cls(**kwargs) surfaces schema drift (a field added or removed
            # since the file was saved) as FormatError below
            for f in dataclasses.fields(cls):
                if f.name.startswith("_"):
                    continue
                key = prefix + f.name
                if f"{key}.__class__" in meta:
                    kwargs[f.name] = build(key + ".", put)
                elif f"__list__{key}" in meta:
                    kwargs[f.name] = [build(f"{key}[{i}].", put)
                                      for i in range(meta[f"__list__{key}"])]
                elif f"__shards__{key}" in meta:
                    kwargs[f.name] = tuple(
                        build(f"{key}[{i}].", put)
                        if f"{key}[{i}].__class__" in meta
                        and (rank is None or i == rank) else None
                        for i in range(meta[f"__shards__{key}"]))
                elif f"a:{key}" in files:
                    kwargs[f.name] = _dev(f"a:{key}", z[f"a:{key}"],
                                          dtypes.get(f"a:{key}"), put)
                elif f"n:{key}" in files:
                    kwargs[f.name] = z[f"n:{key}"]
                elif f"__tuplelen__{key}" in meta:
                    kwargs[f.name] = tuple(
                        _dev(f"t:{key}:{i}", z[f"t:{key}:{i}"],
                             dtypes.get(f"t:{key}:{i}"), put)
                        for i in range(meta[f"__tuplelen__{key}"]))
                elif f"__nt__{key}" in meta:
                    kwargs[f.name] = nt_registry[meta[f"__nt__{key}"]](
                        *_tuplify(meta[key]))
                elif key in meta:
                    kwargs[f.name] = _tuplify(meta[key])
                # else: a field with a default, left to it
            missing = [name for name in getattr(cls, "PORT_FIELDS", ())
                       if name not in kwargs]
            if missing:
                # a file without the port-only fields (written by
                # sblas_tpu, or before the fields existed): derived from
                # the plan's arrays, as `from_numpy` derives them
                host = {f.name: z[f"a:{prefix}{f.name}"]
                        for f in dataclasses.fields(cls)
                        if f"a:{prefix}{f.name}" in files}
                derived = cls.port_fields(host, kwargs)
                kwargs.update({name: put(derived[name])
                               for name in missing})
            if resident:
                return cls(**kwargs).placed(device or "cpu")
            return cls(**kwargs)

        try:
            return build("")
        except (TypeError, KeyError) as e:
            raise FormatError(
                f"plan cache {path} does not match the current plan "
                f"schema ({e}); delete it and rebuild") from e


def place(obj, device, rank: Optional[int] = None):
    """`obj` as `load_plan(..., device, rank=rank)` would return it from
    its file: a shard container keeps only shard `rank` (every shard when
    None) on `device`, a plan moves to `device`."""
    from ..parallel.planned import _placed
    if isinstance(getattr(obj, "plans", None), tuple):
        return dataclasses.replace(obj,
                                   plans=_placed(obj.plans, device, rank))
    return obj.to(device)


def cached_plan(path: str, build, valid=None, *, device, say=None):
    """Load the plan at `path` onto `device` when the file is readable and
    `valid(plan)` holds, else `build()` it, save it, and return what
    `build()` returned.  The one idiom behind the build-once, run-many
    call sites: an unreadable or schema-drifted file falls through to a
    rebuild that overwrites it, and `say` (when given) is told why."""
    if os.path.exists(path):
        try:
            plan = load_plan(path, device)
        except (FormatError, OSError, ValueError, zipfile.BadZipFile) as e:
            plan = None   # unreadable or drifted: rebuild below
            if say is not None:
                say(f"plan cache {path} unusable ({e}); rebuilding")
        if plan is not None and (valid is None or valid(plan)):
            return plan
        if plan is not None and say is not None:
            say(f"plan cache {path} stale (geometry mismatch); rebuilding")
    plan = build()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    save_plan(path, plan)
    return plan
