"""Plan / info serialization — counterpart of
``spblas_tpu/utils/serialize.py``: a plan's inspection is paid once and
reloaded by later jobs.

The file layout is the JAX package's, so a plan saved by either package
loads in the other: one ``.npz`` with ``__classes__`` (prefix ->
``module:qualname``), ``__static__`` (key -> JSON value, tuples as
``{"__tuple__": [...]}``), ``__tuples__`` (key -> length of a tuple of
arrays or plans, one ``key/i`` entry each) and the arrays under
``/``-joined field paths; the legacy single-level form (``__class__``)
is read too.

Port plans carry no ``static`` field metadata: a tensor (or a host numpy
array) is written as an array, a nested plan under its prefix, a tuple
of tensors or plans as a ``__tuples__`` entry, and every other value as
static JSON.  Class names are written under the JAX package's module
names (``spblas_tpu.kernels.ell:EllPlan``) and mapped back to
``spblas_tpu_torch.`` on read; the JAX package is never imported.  Field
names are the JAX dataclasses'; the fields the port adds (the mul plans'
``expansion`` stream, launch starts and work lists, host level offsets)
are written under their own keys, which the JAX package's reader skips,
and the cached 3xTF32 gates of band plans under ``<prefix>tf32_gate`` in
``__port__``, an entry the JAX reader ignores.  Where a JAX-written file
lacks them, they are derived on read as ``utils.interop`` derives them
for a plan carried from the JAX package: a mul plan then has no
``expansion`` stream, and the CUDA numeric refuses it
(``mul_fill.plan_stream``); cached gates are recomputed on first use.
``SpgemmPlan.c_nnz``, a device array in the JAX plan and a host int
here, is written as a 0-d array.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import torch

from spblas_tpu_torch import types as _t

_PORT, _JAX = "spblas_tpu_torch", "spblas_tpu"
# fields the JAX dataclass keeps as arrays and the port as host ints
_HOST_INTS = {"SpgemmPlan": ("c_nnz",)}
# cached properties written beside a plan (band plans' 3xTF32 gate)
_CACHES = ("tf32_gate",)


def _to_jsonable(v):
    if isinstance(v, tuple):
        return {"__tuple__": [_to_jsonable(x) for x in v]}
    if isinstance(v, list):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"save_plan: cannot write {type(v).__name__} {v!r}")


def _from_jsonable(v):
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_from_jsonable(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _structured(v) -> bool:
    """A tuple that holds an array or a plan somewhere (written as a
    ``__tuples__`` entry, not as static JSON)."""
    return isinstance(v, tuple) and any(
        _is_array(x) or dataclasses.is_dataclass(x) or _structured(x)
        for x in v)


class _Writer:
    def __init__(self):
        self.arrays, self.static, self.classes, self.tuples = {}, {}, {}, {}
        self.port = {"bf16": [], "host": [], "none": [], "cache": {}}

    def array(self, key, v):
        if isinstance(v, np.ndarray):
            self.port["host"].append(key)
            self.arrays[key] = v
        elif v.dtype == torch.bfloat16:
            # numpy has no bfloat16: its bits, as uint16
            self.port["bf16"].append(key)
            self.arrays[key] = v.detach().cpu().contiguous().view(
                torch.int16).numpy().view(np.uint16)
        else:
            self.arrays[key] = v.detach().cpu().resolve_conj().numpy()

    def put(self, key, v):
        """One value under ``key``; a None inside a tuple is recorded (a
        None field is omitted, as the JAX package omits it)."""
        if v is None:
            self.port["none"].append(key)
        elif dataclasses.is_dataclass(v):
            self.collect(v, key + "/")
        elif _is_array(v):
            self.array(key, v)
        elif _structured(v):
            self.tuples[key] = len(v)
            for i, x in enumerate(v):
                self.put(f"{key}/{i}", x)
        else:
            self.static[key] = _to_jsonable(v)

    def collect(self, plan, prefix):
        cls = type(plan)
        mod = cls.__module__
        if mod.startswith(_PORT):
            mod = _JAX + mod[len(_PORT):]
        self.classes[prefix or "."] = f"{mod}:{cls.__qualname__}"
        host_ints = _HOST_INTS.get(cls.__name__, ())
        for f in dataclasses.fields(cls):
            v = getattr(plan, f.name)
            key = f"{prefix}{f.name}"
            if f.name in host_ints:
                self.arrays[key] = np.asarray(v)
            elif v is not None:
                self.put(key, v)
        for name in _CACHES:
            if name in plan.__dict__:
                self.port["cache"][f"{prefix}{name}"] = _to_jsonable(
                    plan.__dict__[name])


def save_plan(path: str, plan) -> None:
    """Persist a plan (SpgemmPlan, TrsvPlan, EllPlan, DiaPlan,
    PermutedBandPlan, BandPlan, BsrSpgemmPlan, the ROUTE plans, ...) to
    ``path`` (.npz) in the JAX package's layout; nested plan dataclasses
    are flattened with '/'-joined keys.  Arrays are copied to the
    host."""
    if not dataclasses.is_dataclass(plan):
        raise TypeError(f"not a dataclass plan: {type(plan)!r}")
    w = _Writer()
    w.collect(plan, "")
    np.savez(path,
             __classes__=np.str_(json.dumps(w.classes)),
             __static__=np.str_(json.dumps(w.static)),
             __tuples__=np.str_(json.dumps(w.tuples)),
             __port__=np.str_(json.dumps(w.port)),
             **w.arrays)


def _resolve(qualname: str):
    """The port's class for a ``module:qualname`` of either package."""
    mod_name, _, qual = qualname.partition(":")
    if mod_name == _JAX or mod_name.startswith(_JAX + "."):
        mod_name = _PORT + mod_name[len(_JAX):]
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _carried(plan, parent, absent):
    """A plan read from a file that lacks the fields the port derives
    (``absent``: a JAX-written one), with those fields derived as
    ``utils.interop`` derives them for a plan carried from the JAX
    package; other plans as they are."""
    from spblas_tpu_torch.utils import interop
    name = type(plan).__name__
    dev = _device_of(plan)

    def host(obj, names):
        return {k: None if getattr(obj, k) is None
                else _t.to_numpy(getattr(obj, k)) for k in names}

    def rest(obj, skip):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj) if f.name not in skip}

    if name == "Route2Plan" and "launch_starts" in absent:
        arrays = ("tile", "val", "slab_base", "y_base", "src_flag",
                  "val_src", "ext_cols", "rho")
        return interop.route2_plan_from_numpy(
            host(plan, arrays), rest(plan, arrays + (
                "launch_starts", "slab_work", "solve_work")), device=dev)
    if name == "Route2MulPlan" and "launch_starts" in absent:
        arrays = ("tile1", "tile2", "a_base", "b_base", "src_flag",
                  "y_base")
        return interop.route2_mul_plan_from_numpy(
            host(plan, arrays), rest(plan, arrays + (
                "launch_starts", "expansion")), device=dev)
    if name == "RoutePlan" and "layout" in absent and parent != name:
        from spblas_tpu_torch.kernels.route_plan import fuse_levels
        return fuse_levels(plan)
    if name == "RoutePanedPlan" and plan.panels \
            and plan.panels[0].pane is None:
        arrays = ("tile", "val", "sb", "yb", "fl", "eva", "evb", "evw",
                  "evs", "src_pos", "src_idx", "rho")
        panels = [(host(p, arrays), rest(p, arrays + (
            "pane", "launch_starts"))) for p in plan.panels]
        return interop.route_paned_plan_from_numpy(
            panels, rest(plan, ("panels",)), device=dev)
    if name == "Route2MulPanedPlan" and plan.panels \
            and plan.panels[0].pane is None:
        arrays = ("t1", "t2", "ab", "bb", "yb", "fl", "eva", "evb", "evw",
                  "evs")
        panels = [(host(p, arrays), rest(p, arrays + (
            "pane", "launch_starts"))) for p in plan.panels]
        return interop.route2_mul_paned_plan_from_numpy(
            panels, rest(plan, ("panels", "expansion")), device=dev)
    if name == "TrsvPlan" and "lv_estart_host" in absent:
        return dataclasses.replace(
            plan,
            lv_estart_host=_t.to_numpy(plan.lv_estart).astype(np.int64),
            lv_rstart_host=_t.to_numpy(plan.lv_rstart).astype(np.int64))
    return plan


def _device_of(plan):
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, tuple):
            for x in v:
                if dataclasses.is_dataclass(x):
                    return _device_of(x)
    return None


class _Reader:
    def __init__(self, z, device):
        self.z = z
        self.dev = device
        self.files = set(z.files)
        self.port = {"bf16": [], "host": [], "none": [], "cache": {}}
        if "__port__" in self.files:
            self.port.update(json.loads(str(z["__port__"])))

    def array(self, key):
        a = self.z[key]
        if key in self.port["host"]:
            return a
        if key in self.port["bf16"]:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(self.dev)
        return _t.as_tensor(a, self.dev)

    def get(self, key, ctx, parent):
        """The value under ``key``, or ``_ABSENT``."""
        classes, static, tuples = ctx
        if key in static:
            return _from_jsonable(static[key])
        if key in tuples:
            return tuple(self.get(f"{key}/{i}", ctx, parent)
                         for i in range(tuples[key]))
        if (key + "/") in classes:
            return self.rebuild(key + "/", ctx, parent)
        if key in self.files:
            return self.array(key)
        if key in self.port["none"]:
            return None
        return _ABSENT

    def rebuild(self, prefix, ctx, parent=None):
        cls = _resolve(ctx[0][prefix or "."])
        host_ints = _HOST_INTS.get(cls.__name__, ())
        kwargs, absent = {}, set()
        for f in dataclasses.fields(cls):
            v = self.get(f"{prefix}{f.name}", ctx, cls.__name__)
            if v is _ABSENT:
                if (f.default is dataclasses.MISSING
                        and f.default_factory is dataclasses.MISSING):
                    # an omitted field held None when it was saved
                    kwargs[f.name] = None
                else:
                    absent.add(f.name)
            else:
                kwargs[f.name] = int(v) if f.name in host_ints else v
        plan = _carried(cls(**kwargs), parent, absent)
        for name in _CACHES:
            if f"{prefix}{name}" in self.port["cache"]:
                plan.__dict__[name] = _from_jsonable(
                    self.port["cache"][f"{prefix}{name}"])
        return plan


_ABSENT = object()


def load_plan(path: str, device=None):
    """Reload a plan saved by :func:`save_plan` of either package; its
    arrays come back on ``device`` (the card unless the caller names
    another)."""
    dev = _t.resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        r = _Reader(z, dev)
        if "__classes__" in r.files:
            ctx = (json.loads(str(z["__classes__"])),
                   json.loads(str(z["__static__"])),
                   json.loads(str(z["__tuples__"]))
                   if "__tuples__" in r.files else {})
            return r.rebuild("", ctx)
        # legacy single-level format
        cls = _resolve(str(z["__class__"]))
        kwargs = {k: _from_jsonable(v)
                  for k, v in json.loads(str(z["__static__"])).items()}
        for f in dataclasses.fields(cls):
            if f.name in r.files:
                kwargs[f.name] = r.array(f.name)
        absent = {f.name for f in dataclasses.fields(cls)
                  if f.name not in kwargs}
        return _carried(cls(**kwargs), None, absent)
