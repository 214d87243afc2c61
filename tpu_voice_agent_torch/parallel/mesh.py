"""Device mesh and placement plans: the dp x tp layout of the dense engine.

Port of ``tpu_voice_agent/parallel/mesh.py``. JAX writes the layout as
``NamedSharding`` rules and lets XLA insert the collectives; the port writes
the same plans and carries them out by hand:

- ``Mesh`` is one process's grid of ``torch.device``s with named axes
  (``mesh.shape["tp"]`` as in JAX). It is not a ``torch.distributed``
  group, for the reason ``parallel.ring`` gives: the serving design is one
  controller owning every device of the mesh.
- a spec is JAX's ``PartitionSpec`` as a tuple: entry d names the mesh axis
  tensor axis d splits over, or None (whole on every device).
- ``Sharded`` is a tensor laid over a mesh by a spec: ``shards[c]`` is the
  contiguous local block on mesh device ``c``. ``place`` lays a tensor out
  (one copy per distinct block and device), ``Sharded.full`` gathers it.

Tensor-parallel layout (Megatron), as JAX's ``param_shardings``: wq / wk /
wv and w_gate / w_up split their output axis over tp (column parallel), wo
and w_down their input axis (row parallel), so a block needs one sum of the
shards' partials after wo and one after w_down (``models.llama`` takes them
in one fixed order); lm_head splits the vocab and the logits are gathered;
an MoE config splits the expert axis over tp. ``paged_pool_shardings`` and
``paged_scale_shardings`` come with the paged engine on a mesh (ROADMAP.md
Queue 1 item 8c, second part).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


class Mesh:
    """A grid of devices with named axes (``np.ndarray`` of ``torch.device``,
    ``axis_names``); ``shape`` maps each name to its size."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        flat = [torch.device(d) if isinstance(d, str) else d
                for d in np.asarray(devices, dtype=object).reshape(-1)]
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid needs as many axis names, "
                             f"got {self.axis_names}")

    @classmethod
    def from_devices(cls, shape: tuple[int, ...], axis_names: tuple[str, ...],
                     devices: list | None = None) -> "Mesh":
        """The first prod(shape) of ``devices`` (default every visible card),
        row-major into a grid of ``shape``."""
        devices = list(devices if devices is not None else visible_devices())
        n = int(np.prod(shape))
        if n > len(devices):
            what = (f"{axis_names[0]}={shape[0]}" if len(shape) == 1
                    else "mesh " + "x".join(map(str, shape)))
            raise ValueError(f"{what} needs {n} devices, have {len(devices)}")
        grid = np.empty(n, dtype=object)
        grid[:] = devices[:n]
        return cls(grid.reshape(shape), axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self) -> list[tuple[int, ...]]:
        """Every device coordinate, row-major."""
        return list(np.ndindex(*self.devices.shape))

    def device(self, c: tuple[int, ...]) -> torch.device:
        return self.devices[c]

    def row(self, i: int) -> "Mesh":
        """The sub-mesh at index ``i`` of the first axis, the axis kept at
        size 1 (a dp group of a (dp, tp) mesh, a stage of a (pp, tp) one)."""
        return Mesh(self.devices[i:i + 1], self.axis_names)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(str(d) for d in self.devices.flat)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def visible_devices() -> list[torch.device]:
    """Every visible CUDA card (the default device list of every mesh)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dp: int = 1, tp: int = 1, devices: list | None = None) -> Mesh:
    return Mesh.from_devices((dp, tp), ("dp", "tp"), devices)


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device: a kernel launches on the current
    device, so each shard's launches run with its own card current."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# ---------------------------------------------------------------- sharded tensors


def _block(shape, spec, mesh: Mesh, c) -> tuple[slice, ...]:
    """The index of device ``c``'s block of a tensor of ``shape``."""
    out = []
    for d, (n, ax) in enumerate(zip(shape, spec)):
        if ax is None:
            out.append(slice(None))
            continue
        k = mesh.shape[ax]
        if n % k:
            raise ValueError(f"axis {d} of size {n} does not divide over mesh axis "
                             f"{ax!r} of size {k}")
        i = c[mesh.axis_names.index(ax)]
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def _norm_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} is longer than the tensor's {ndim} axes")
    return spec


class Sharded:
    """A tensor of global ``shape`` laid over ``mesh`` by ``spec``;
    ``shards[c]`` is device c's contiguous local block."""

    def __init__(self, mesh: Mesh, spec, shape, shards: dict):
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.spec = _norm_spec(spec, len(self.shape))
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    def local(self, c) -> torch.Tensor:
        return self.shards[c]

    @classmethod
    def from_locals(cls, mesh: Mesh, spec, shards: dict) -> "Sharded":
        """Wrap per-device blocks; the global shape follows from spec."""
        t = shards[(0,) * mesh.devices.ndim]
        spec = _norm_spec(spec, t.dim())
        shape = [n * (mesh.shape[ax] if ax else 1) for n, ax in zip(t.shape, spec)]
        return cls(mesh, spec, shape, shards)

    @classmethod
    def zeros(cls, mesh: Mesh, shape, spec, dtype) -> "Sharded":
        """Fresh zeros, one block a device (never shared between devices)."""
        spec = _norm_spec(spec, len(shape))
        shards = {}
        for c in mesh.coords():
            blk = _block(shape, spec, mesh, c)
            local = [len(range(*s.indices(n))) for s, n in zip(blk, shape)]
            shards[c] = torch.zeros(local, dtype=dtype, device=mesh.device(c))
        return cls(mesh, spec, shape, shards)

    def __getitem__(self, i: int) -> "Sharded":
        """Index the first axis (which must not be split): per-layer views
        of a stacked leaf, as ``models.llama.unstack_layers`` takes them."""
        if not isinstance(i, int) or self.spec[0] is not None:
            raise ValueError("a Sharded tensor is indexed by an int on an unsplit first axis")
        return Sharded(self.mesh, self.spec[1:], self.shape[1:],
                       {c: t[i] for c, t in self.shards.items()})

    def row(self, i: int) -> "Sharded":
        """The blocks of ``mesh.row(i)``, as a tensor over that sub-mesh."""
        sub = self.mesh.row(i)
        shards = {(0,) + c[1:]: t for c, t in self.shards.items() if c[0] == i}
        first = self.mesh.axis_names[0]
        shape = [n // self.mesh.shape[first] if ax == first else n
                 for n, ax in zip(self.shape, self.spec)]
        return Sharded(sub, self.spec, shape, shards)

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default the mesh's first)."""
        device = torch.device(device) if device is not None else self.mesh.devices.flat[0]
        used = {ax for ax in self.spec if ax}
        blocks = {c: t for c, t in self.shards.items()
                  if all(c[k] == 0 for k, ax in enumerate(self.mesh.axis_names)
                         if ax not in used)}
        blocks = {c: t.to(device) for c, t in blocks.items()}
        for d, ax in enumerate(self.spec):
            if ax is None:
                continue
            k = self.mesh.axis_names.index(ax)
            merged: dict = {}
            for c in sorted(blocks):
                key = c[:k] + (0,) + c[k + 1:]
                merged.setdefault(key, []).append(blocks[c])
            blocks = {key: torch.cat(parts, dim=d) for key, parts in merged.items()}
        (out,) = blocks.values()
        return out

    def nbytes(self) -> int:
        """Bytes of the distinct blocks (replicas that share a tensor count once)."""
        seen = {(t.device, t.data_ptr(), t.numel()): t.numel() * t.element_size()
                for t in self.shards.values()}
        return sum(seen.values())

    def __repr__(self) -> str:
        return f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, {self.mesh!r})"


def place(x: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """Lay ``x`` out over ``mesh``: each distinct block is made contiguous
    once and moved to each device that holds it (a block already on its
    device is shared, not copied)."""
    spec = _norm_spec(spec, x.dim())
    blocks: dict = {}
    shards = {}
    for c in mesh.coords():
        blk = _block(x.shape, spec, mesh, c)
        key = tuple((s.start, s.stop) for s in blk)
        if key not in blocks:
            blocks[key] = x[blk].contiguous()
        shards[c] = blocks[key].to(mesh.device(c))
    return Sharded(mesh, spec, x.shape, shards)


def _effective(spec, mesh: Mesh) -> tuple:
    """A spec with splits over size-1 mesh axes written as None (the same layout)."""
    return tuple(ax if ax and mesh.shape[ax] > 1 else None for ax in spec)


def as_sharded(x, mesh: Mesh, spec) -> Sharded:
    """``x`` laid out by ``spec``: a ``Sharded`` must already be (a layout
    is never changed behind the caller's back); a tensor is placed."""
    if isinstance(x, Sharded):
        spec = _norm_spec(spec, len(x.shape))
        if x.mesh != mesh or _effective(x.spec, mesh) != _effective(spec, mesh):
            raise ValueError(f"operand laid out as {x.spec} on {x.mesh!r}, "
                             f"the kernel's shards need {spec} on {mesh!r}")
        return x
    return place(x, mesh, spec)


def place_tree(tree, mesh: Mesh, specs):
    """``place`` every leaf of a (nested dict) tree by the matching spec;
    an int8 ``{"q", "s"}`` leaf takes a ``{"q", "s"}`` spec pair."""
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, specs[k]) for k, v in tree.items()}
    return place(tree, mesh, specs)


def local_tree(tree, c):
    """Device ``c``'s blocks of a tree of ``Sharded`` leaves."""
    if isinstance(tree, dict):
        return {k: local_tree(v, c) for k, v in tree.items()}
    return tree.local(c)


def tree_row(tree, i: int):
    """``Sharded.row(i)`` of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_row(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_row(v, i) for v in tree]
    return tree.row(i)


# ---------------------------------------------------------------- plans


@dataclass(frozen=True)
class ShardingRules:
    """Named activation layouts of the meshed forward: ``specs`` maps the
    constraint points of JAX's model code to their specs; an absent name is
    unconstrained (for "heads" / "kv_heads": replicated over tp)."""

    mesh: Mesh
    specs: tuple[tuple[str, tuple], ...]


def default_rules(mesh: Mesh, n_kv_heads: int, n_heads: int) -> ShardingRules:
    tp = mesh.shape["tp"]
    specs: list[tuple[str, tuple]] = [
        ("act", ("dp", None, None)),
        ("logits", ("dp", None, None)),
        ("ffn", ("dp", None, "tp")),
    ]
    if n_heads % tp == 0:
        specs.append(("heads", ("dp", None, "tp", None)))
    if n_kv_heads % tp == 0:
        specs.append(("kv_heads", ("dp", None, "tp", None)))
    return ShardingRules(mesh=mesh, specs=tuple(specs))


def param_shardings(mesh: Mesh, n_kv_heads: int, n_experts: int = 0) -> dict:
    """Spec tree matching ``models.llama.init_params``: Megatron column / row
    parallel over tp, wk / wv replicated when tp does not divide the kv
    heads, the stacked (L, E, d, f) expert leaves split on E (replicated when
    tp does not divide E), embed replicated, lm_head over the vocab."""
    tp = mesh.shape["tp"]
    col, row, rep2 = (None, None, "tp"), (None, "tp", None), (None, None)
    kv = col if n_kv_heads % tp == 0 else (None, None, None)
    layers = {"attn_norm": rep2, "wq": col, "wk": kv, "wv": kv, "wo": row, "mlp_norm": rep2}
    if n_experts > 0:
        ep = "tp" if n_experts % tp == 0 else None
        layers.update({"router": (None, None, None), "moe_gate": (None, ep, None, None),
                       "moe_up": (None, ep, None, None), "moe_down": (None, ep, None, None)})
    else:
        layers.update({"w_gate": col, "w_up": col, "w_down": row})
    return {"embed": rep2, "layers": layers, "final_norm": (None,), "lm_head": (None, "tp")}


def kv_cache_shardings(mesh: Mesh, n_kv_heads: int) -> dict:
    spec = (None, "dp", None, "tp" if n_kv_heads % mesh.shape["tp"] == 0 else None, None)
    return {"k": spec, "v": spec}


def quantized_param_shardings(mesh: Mesh, n_kv_heads: int, n_experts: int = 0) -> dict:
    """``param_shardings`` for an int8 tree: each quantized leaf becomes a
    ``{"q", "s"}`` pair, q with the weight's spec, s (the per-out-channel
    scale, a size-1 reduced axis at -2) the same minus that axis."""
    raw = param_shardings(mesh, n_kv_heads, n_experts)

    def quantize_leaf(spec):
        s = list(spec)
        if len(s) >= 2:
            s[-2] = None
        return {"q": spec, "s": tuple(s)}

    layers = {k: (quantize_leaf(v) if k.startswith(("w", "moe_")) else v)
              for k, v in raw["layers"].items()}
    return {"embed": raw["embed"], "layers": layers, "final_norm": raw["final_norm"],
            "lm_head": quantize_leaf(raw["lm_head"])}
