"""Sequence parallelism: ring attention and Ulysses (all-to-all) attention.

Port of ``tpu_voice_agent/parallel/ring.py``. The sequence axis of q/k/v is
split into ``sp`` shards, one per device of an ``sp`` mesh, and both
functions are exact (they match full attention to numerical tolerance):

- ``ring_attention``: each device attends its query shard to the key/value
  shards as they come round the ring, one hop a step, and merges the
  blocks' partial outputs by their log-sum-exp (online softmax). Every
  block is one K1 launch (``ops.flash_attention`` with ``return_lse`` and an
  fp32 output): the diagonal block causal, earlier blocks non-causal, later
  ones skipped under ``causal``. The merge runs in fp32 in JAX's order (the
  diagonal block first, then r - 1, r - 2, ... mod sp) and the result is
  rounded to ``q.dtype`` once.
- ``ulysses_attention``: re-shards sequence shards into head groups (an
  all-to-all done as per-device ``chunk`` / ``cat``), runs K1 over the
  full sequence for each head group, and re-shards back.

The mesh is one process's list of devices (``sp_mesh``), not a
``torch.distributed`` process group: JAX's planner is single-controller, one
process owning the whole ``sp`` axis with its sessions, per-session locks
and plan-gather thread, and a process group would split those across
processes, a second serving design the JAX package does not have. A hop
is ``.to(device, non_blocking=True)``, free when two shards share a device
(``[cuda:0] * sp`` on one card runs the multi-block merge there). A
kernel launches on the current CUDA device, so each block runs with its
shard's card made current. On CUDA tensors every block launches K1; the
plain versions run only on CPU tensors, as for every kernel wrapper.
"""

from __future__ import annotations

import torch

from ..ops import flash_attention
from .mesh import on_device as _on


def sp_mesh(sp: int, devices: list | None = None) -> list[torch.device]:
    """The 1-D sequence-parallel mesh: the first ``sp`` of ``devices``
    (default every visible CUDA card). Tests pass ``[torch.device("cpu")] *
    sp``, as JAX's run on virtual CPU devices."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if sp > len(devices):
        raise ValueError(f"sp={sp} needs {sp} devices, have {len(devices)}")
    return devices[:sp]


def _shards(x: torch.Tensor, mesh: list[torch.device]) -> list[torch.Tensor]:
    """x (B, T, H, hd) split on T, shard r on mesh[r] (contiguous)."""
    n = len(mesh)
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} not divisible by sp={n}")
    return [c.to(dev, non_blocking=True).contiguous()
            for c, dev in zip(torch.chunk(x, n, dim=1), mesh)]


@torch.no_grad()
def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: list[torch.device], *, causal: bool = True,
                   scale: float | None = None) -> torch.Tensor:
    """Exact attention of q (B, T, nq, hd) over k/v (B, T, nkv, hd), T split
    over ``mesh``. Returns (B, T, nq, hd) in q.dtype on q's device."""
    n = len(mesh)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qs, k_cur, v_cur = _shards(q, mesh), _shards(k, mesh), _shards(v, mesh)
    acc: list = [None] * n  # per device: merged output (fp32) and its lse
    lse: list = [None] * n
    for s in range(n):
        if s:
            # one hop: device r receives the block device r - 1 held, so
            # after s hops it holds block (r - s) mod n
            k_cur = [k_cur[(r - 1) % n].to(mesh[r], non_blocking=True) for r in range(n)]
            v_cur = [v_cur[(r - 1) % n].to(mesh[r], non_blocking=True) for r in range(n)]
        for r in range(n):
            j = (r - s) % n
            if causal and j > r:
                continue  # every key of a later block is masked for every query here
            with _on(mesh[r]):
                o_j, l_j = flash_attention(qs[r], k_cur[r], v_cur[r], causal=causal and j == r,
                                           scale=scale, return_lse=True,
                                           out_dtype=torch.float32)
            if acc[r] is None:
                acc[r], lse[r] = o_j, l_j
                continue
            m = torch.maximum(lse[r], l_j)
            a, b = torch.exp(lse[r] - m), torch.exp(l_j - m)
            tot = a + b
            acc[r] = acc[r] * (a / tot)[..., None] + o_j * (b / tot)[..., None]
            lse[r] = m + torch.log(tot)
    return torch.cat([o.to(q.device) for o in acc], dim=1).to(q.dtype)


@torch.no_grad()
def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: list[torch.device], *, causal: bool = True,
                      scale: float | None = None) -> torch.Tensor:
    """All-to-all head-parallel attention (Ulysses layout): sequence shards
    -> head groups, K1 over the full sequence per group, -> sequence shards.
    Both head counts must divide by sp."""
    n = len(mesh)
    nq, nkv = q.shape[2], k.shape[2]
    if nq % n or nkv % n:
        raise ValueError(f"ulysses needs nq ({nq}) and nkv ({nkv}) divisible by sp ({n})")
    qs, ks, vs = _shards(q, mesh), _shards(k, mesh), _shards(v, mesh)

    def a2a(shards, split: int, cat: int):
        # device r gathers piece r of every device's shard (split axis) and
        # concatenates them on the other axis
        parts = [torch.chunk(x, n, dim=split) for x in shards]
        return [torch.cat([parts[j][r].to(mesh[r], non_blocking=True) for j in range(n)],
                          dim=cat).contiguous() for r in range(n)]

    qh, kh, vh = a2a(qs, 2, 1), a2a(ks, 2, 1), a2a(vs, 2, 1)  # (B, T, H / n, hd)
    oh = []
    for r in range(n):
        with _on(mesh[r]):
            oh.append(flash_attention(qh[r], kh[r], vh[r], causal=causal, scale=scale))
    out = a2a(oh, 1, 2)  # (B, T / n, nq, hd) on each device
    return torch.cat([o.to(q.device) for o in out], dim=1)
