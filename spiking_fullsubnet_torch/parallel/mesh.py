"""The device mesh and its axes (counterpart of
``spiking_fullsubnet_tpu/parallel/mesh.py``).

The JAX package lays its chips out as a ``jax.sharding.Mesh`` with a
``data`` axis (the utterance batch) and optionally a ``band`` axis (the
folded sub-band units of each utterance, ``models/fused_forward.py``). Here
a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one rank a card, with the same shape rules
(``make_mesh``). Its axes are process groups:

- ``data``: each data rank runs its own shard of the batch
  (``shard_batch``), and its BatchNorm statistics are its own rows', as
  under the data parallelism of ``parallel/dist.py`` and the reference's DDP;
- ``band``: the ranks of one band group hold the same rows and split each
  section's sub-band units among them. BatchNorm's statistics of a split
  section are summed over the band group at every step (kernels D and E in
  band mode, ``ops/gsu_kernels.py``), which is what makes the split equal
  to one device.

``with mesh:`` makes a mesh the enclosing one, as in JAX; the forward reads
it through ``current_axis_size`` and ``axis_group``. After a step on a band
split, every rank holds its own rows' share of the gradients:
``reduce_gradients`` sums them over the band group and averages them over
the data group.

A band group on cards swaps BN's sums by one of two routes, chosen once a
group from its topology before any launch (``band_route``) and logged:
"peer", where every rank has a card of its own on one host and each pair
of cards has peer access (kernels D and E exchange the sums over peer
memory inside one launch a layer; ``band_setup`` allocates each rank's
buffer and maps its peers' over CUDA IPC), or "staged" (the sums through
``AxisGroup.all_reduce`` between launches a step), where ranks share a card
or the group spans hosts. The route never changes because something failed.
``release_band_exchanges`` (``parallel.dist.shutdown``) frees the buffers.
"""

from __future__ import annotations

import logging
import math
import socket
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _placements():
    """DTensor's ``(Shard, Replicate)``, imported at first use."""
    try:  # torch >= 2.4
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:  # pragma: no cover - older torch
        from torch.distributed._tensor import Replicate, Shard
    return Shard, Replicate


def mesh_shape(axis_names: Tuple[str, ...], axis_sizes: Optional[Sequence[int]],
               n: int) -> List[int]:
    """The shape ``make_mesh`` gives ``n`` ranks (``mesh.py:18-38``): all of
    them on the first axis by default; one size of -1 is what the other
    sizes leave of ``n``."""
    if axis_sizes is None:
        return [n] + [1] * (len(axis_names) - 1)
    shape = list(axis_sizes)
    unknown = [i for i, s in enumerate(shape) if s == -1]
    if unknown:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[unknown[0]] = n // known
    return shape


def make_mesh(axis_names: Tuple[str, ...] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``axis_names`` over the ranks ``devices`` (default
    every rank of the group, in rank order), laid out as ``mesh_shape``
    says: rank ``devices[i]`` sits where JAX puts ``devices[i]``. Its device
    type is ``cuda`` under NCCL and ``cpu`` under gloo (whose collectives
    take CUDA tensors too, as when two ranks share a card). Needs the
    process group (``parallel.initialize_distributed``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.initialize_distributed first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    shape = mesh_shape(tuple(axis_names), axis_sizes, len(ranks))
    if math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {shape} does not hold {len(ranks)} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _axis_index(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh axes {names} have no {name!r}")
    return names.index(name)


def batch_sharding(mesh, batch_axis: str = "data") -> Tuple[Any, ...]:
    """The placements of a batch on ``mesh``: dim 0 split over
    ``batch_axis``, replicated over every other axis (JAX's
    ``NamedSharding(mesh, P(batch_axis))``)."""
    Shard, Replicate = _placements()
    k = _axis_index(mesh, batch_axis)
    return tuple(Shard(0) if i == k else Replicate() for i in range(mesh.ndim))


def replicated_sharding(mesh) -> Tuple[Any, ...]:
    """Every axis replicated (``NamedSharding(mesh, P())``)."""
    _, Replicate = _placements()
    return tuple(Replicate() for _ in range(mesh.ndim))


def _rows(x, index: int, parts: int):
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        return x
    n = x.shape[0]
    if n % parts:
        raise ValueError(f"a batch of {n} rows does not split over {parts} data ranks")
    step = n // parts
    return x[index * step:(index + 1) * step]


def shard_batch(mesh, batch, batch_axis: str = "data"):
    """This rank's rows of a host batch (a tensor or array, or a dict, list
    or tuple of them, dim 0 the batch): the block of ``batch_axis``'s
    coordinate of this rank, which is what JAX's ``batch_sharding`` places
    on the matching device. Every rank of one band group gets the same
    rows."""
    parts = mesh.size(_axis_index(mesh, batch_axis))
    index = mesh.get_local_rank(batch_axis)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return _rows(t, index, parts)

    return walk(batch)


def current_mesh():
    """The enclosing mesh (``with mesh:``), or None outside one."""
    try:
        from torch.distributed.device_mesh import _mesh_resources
    except ImportError:  # pragma: no cover - torch without the mesh
        return None
    stack = getattr(_mesh_resources, "mesh_stack", None)
    if stack is not None:
        return stack[-1] if stack else None
    try:
        return _mesh_resources.get_current_mesh()
    except RuntimeError:
        return None


def current_axis_size(name: str) -> Optional[int]:
    """The size of axis ``name`` of the enclosing mesh (``with mesh:``), or
    None outside a mesh or where it has no such axis. None means that the
    forward does not split along that axis and runs as on one device: that
    is the JAX package's own rule (``fused_forward.py:193-206`` there, where
    ``band_size`` None takes no band sharding), not a fallback."""
    mesh = current_mesh()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return int(mesh.size(_axis_index(mesh, name)))


@dataclass(frozen=True)
class AxisGroup:
    """One axis of the enclosing mesh as this rank sees it: its size, this
    rank's coordinate on it and the process group of the ranks that share
    every other coordinate."""
    name: str
    size: int
    rank: int
    group: Any

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place; returns ``t``."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in coordinate order."""
        src = t.detach().contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return out

    def band_exchange(self, device: torch.device):
        """The group's exchange of the peer route for kernels D and E in band
        mode (``ops/gsu_kernels.BandExchange``), or None on the staged route
        (``band_setup``)."""
        return band_setup(self, device).exchange


def axis_group(name: str) -> Optional[AxisGroup]:
    """Axis ``name`` of the enclosing mesh (``AxisGroup``), or None where
    ``current_axis_size`` is None."""
    mesh = current_mesh()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    k = _axis_index(mesh, name)
    return AxisGroup(name, int(mesh.size(k)), int(mesh.get_local_rank(name)),
                     mesh.get_group(name))


class _AllReduce(torch.autograd.Function):
    """A sum over the group whose result every rank holds: the gradient of
    each rank's share is the sum of every rank's gradient of the result."""

    @staticmethod
    def forward(ctx, x, ag):
        ctx.ag = ag
        return ag.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.ag.all_reduce(g.contiguous().clone()), None


class _AllGather(torch.autograd.Function):
    """Every rank's piece concatenated along ``dim`` in coordinate order;
    each rank's gradient is its own piece's, once."""

    @staticmethod
    def forward(ctx, x, ag, dim):
        ctx.ag, ctx.dim, ctx.n = ag, dim, x.shape[dim]
        return torch.cat(ag.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ag.rank * ctx.n, ctx.n), None, None


def all_reduce_sum(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``ag``'s ranks."""
    return _AllReduce.apply(x, ag)


def all_gather_cat(x: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """Differentiable concatenation of every rank's ``x`` along ``dim``."""
    return _AllGather.apply(x, ag, dim)


def reduce_gradients(weights: Iterable[torch.Tensor], mesh=None, data_axis: str = "data",
                     band_axis: str = "band") -> int:
    """Every weight's ``.grad``, in place: summed over ``band_axis`` (each
    band rank holds its own rows' share after a band-split step), then
    averaged over ``data_axis``. ``mesh`` defaults to the enclosing one; an
    axis the mesh lacks is skipped. One flat bucket a dtype and axis.
    Before the sum, the band group's exchange (the peer route) is checked
    once for the step: this waits for its last launch and raises if an
    exchange failed (``BandExchange.check``). Returns the number of
    ``all_reduce`` calls."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("reduce_gradients needs a mesh (make_mesh, or `with mesh:`)")
    grads = [w.grad for w in weights if w.grad is not None]
    names = mesh.mesh_dim_names or ()
    calls = 0
    for axis, mean in ((band_axis, False), (data_axis, True)):
        if axis not in names:
            continue
        k = _axis_index(mesh, axis)
        size, group = mesh.size(k), mesh.get_group(axis)
        setup = _BAND_SETUPS.get(group) if axis == band_axis else None
        if setup is not None and setup.exchange is not None:
            setup.exchange.check()
        buckets = {}
        for g in grads:
            buckets.setdefault((g.dtype, g.device), []).append(g)
        for bucket in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=group)
            if mean:
                flat.div_(size)
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            calls += 1
    return calls


# ---------------------------------------------------------------- the band group's exchange

log = logging.getLogger(__name__)
BAND_ROUTES = ("peer", "staged")


def card_info(device: torch.device) -> Dict[str, Any]:
    """This rank's card as the route needs it: the host, the card's UUID,
    and which of the cards this process sees its card reaches by peer access
    (UUID -> bool; its own True)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    uuids = [str(torch.cuda.get_device_properties(k).uuid) for k in range(torch.cuda.device_count())]
    return {"host": socket.gethostname(), "uuid": uuids[idx],
            "access": {u: k == idx or torch.cuda.can_device_access_peer(idx, k)
                       for k, u in enumerate(uuids)}}


def band_route(infos: Sequence[Dict[str, Any]]) -> Tuple[str, str]:
    """(route, why) of a band group from each rank's ``card_info``, in group
    order: "peer" when every rank is on a card of its own of one host and
    each rank's card reaches every other rank's by peer access (so every
    rank must see the group's cards); else "staged": ranks that share a
    card (their kernels would not run at once without MPS, and one spinning
    on a peer's flag would wait on the time slicer) or a group across
    hosts."""
    hosts = {i["host"] for i in infos}
    if len(hosts) > 1:
        return "staged", f"the group spans {len(hosts)} hosts"
    uuids = [i["uuid"] for i in infos]
    if len(set(uuids)) < len(uuids):
        return "staged", f"{len(uuids)} ranks share {len(set(uuids))} card(s)"
    for g, info in enumerate(infos):
        for h, u in enumerate(uuids):
            if h != g and not info["access"].get(u, False):
                return "staged", f"rank {g}'s card has no peer access to rank {h}'s"
    return "peer", f"{len(uuids)} ranks on cards of their own, each pair with peer access"


@dataclass
class BandSetup:
    """A band group's route (``band_route``), why, and its exchange on the
    peer route (None on the staged one); ``mapped`` the peers' buffers this
    process mapped, ``own`` its own buffer (released by
    ``release_band_exchanges``); ``seconds`` the setup's host time."""
    route: str
    why: str
    exchange: Any = None
    device: Optional[torch.device] = None
    own: int = 0
    mapped: Tuple[int, ...] = ()
    seconds: float = 0.0


_BAND_SETUPS: Dict[Any, BandSetup] = {}


def band_setup(ag: AxisGroup, device: torch.device) -> BandSetup:
    """The band group's route and exchange, set up at the first call of a
    group (every rank of the group calls it at the same point: it gathers
    each rank's ``card_info``, then on the peer route each rank's buffer
    handle) and cached on the group."""
    if ag.group in _BAND_SETUPS:
        return _BAND_SETUPS[ag.group]
    t0 = time.perf_counter()
    infos: List[Any] = [None] * ag.size
    dist.all_gather_object(infos, card_info(device), group=ag.group)
    route, why = band_route(infos)
    setup = BandSetup(route, why, device=device)
    if route == "peer":
        from ..ops import gsu_kernels as gk

        own, handle = gk.band_buffer_alloc(device, ag.size)
        handles: List[Any] = [None] * ag.size
        dist.all_gather_object(handles, handle, group=ag.group)
        bases = [own if g == ag.rank else gk.band_buffer_open(device, h)
                 for g, h in enumerate(handles)]
        setup.own = own
        setup.mapped = tuple(b for g, b in enumerate(bases) if g != ag.rank)
        setup.exchange = gk.BandExchange(ag.size, ag.rank, bases,
                                         own + gk.exchange_layout(ag.size)["err"])
    setup.seconds = time.perf_counter() - t0
    log.info("band group of %d ranks (rank %d on %s): route %s: %s (set up in %.3f s)", ag.size,
             ag.rank, device, route, why, setup.seconds)
    _BAND_SETUPS[ag.group] = setup
    return setup


def band_setup_of(group) -> Optional[BandSetup]:
    """The setup of a band group's process group, where it has one."""
    return _BAND_SETUPS.get(group)


def release_band_exchanges() -> None:
    """Every band group's exchange: each rank unmaps its peers' buffers, waits
    for the group, then frees its own. Every rank of each group calls it
    (``parallel.dist.shutdown``)."""
    from ..ops import gsu_kernels as gk

    for group, setup in list(_BAND_SETUPS.items()):
        if setup.exchange is not None:
            torch.cuda.synchronize(setup.device)
            for ptr in setup.mapped:
                gk.band_buffer_release(setup.device, ptr, own=False)
            dist.barrier(group=group)
            gk.band_buffer_release(setup.device, setup.own, own=True)
        del _BAND_SETUPS[group]
