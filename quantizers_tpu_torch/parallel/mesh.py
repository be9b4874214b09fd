"""Meshes of ranks, the placement rules of a params tree, and the shards.

Counterpart of ``quantizers_tpu/parallel/mesh.py``. The JAX package writes
PartitionSpecs and lets GSPMD place the arrays and insert collectives; the
port makes both explicit:

* :func:`make_mesh` lays the ranks of ``torch.distributed`` out on named
  axes (``dp`` over batches, ``tp`` over heads and features, ``ep`` over
  experts, ``cp`` over the sequence of :mod:`.ring`), with one process
  group per axis;
* :func:`param_pspecs` gives the placement tree of a params tree, leaf for
  leaf with the JAX package's rules (Megatron style):

  - column-parallel projections (``q/k/v``, ``gate/up``, the MLA ``b``
    expansions, an untied ``lm_head``): output features over ``tp``;
  - row-parallel projections (``o_proj``, ``down_proj``): the contraction
    axis over ``tp``;
  - expert stacks: the expert axis over ``ep``, else over ``tp``;
  - ``mla_absorb``: its head axis over ``tp``;
  - the ``a`` projections, routers, norms and the embedding replicated;

* :func:`shard_params` reads each leaf's placement from
  :func:`param_pspecs` through :func:`compatible_pspec`, slices each
  rank's shard on the host and moves only that shard to the rank's device.
  It returns the rank-local spec (the rank's head counts) with the
  rank-local tree, in which a row-parallel linear is a
  :class:`~.collectives.RowParallel`, an untied head a
  :class:`~.collectives.ColumnGather`, and an expert stack records its
  shard count and first expert (``moe["expert_group"]`` names the axis its
  outputs are summed over). Shards stay plain tensors, because the kernels
  take raw pointers.

Where the JAX package's rules leave the layout to GSPMD, the port's shards
follow the arrays' meaning:

* **split-half packing**: w4 and NVFP4 pack rows ``p`` and ``K/2 + p`` in
  one byte (:mod:`~quantizers_tpu_torch.ops.linear`), so a row-parallel
  shard unpacks the codes, takes its logical rows ``[r K/tp, (r+1) K/tp)``
  and packs them again, with the scale rows of the same groups;
* **fused layouts**: a fused ``qkv_proj`` or ``gateup_proj`` splits per
  segment (each rank takes its q, k and v heads, its slice of gate and of
  up), not as one concatenation;
* **heads**: a split falls on head boundaries. Where ``tp`` does not
  divide the KV heads, k and v are replicated (the compatible rule) and
  each rank keeps the KV heads its own query heads read.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..models.config import ModelSpec
from ..models.moe import ExpertLinears
from ..ops.linear import QuantLinear
from .collectives import AxisGroup, ColumnGather, RowParallel


class P(tuple):
    """A placement: per dimension of an array, the mesh axis it is split
    over, or None where it is replicated (JAX's ``PartitionSpec``)."""

    def __new__(cls, *dims: Optional[str]) -> "P":
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the ranks of ``torch.distributed``.

    ``devices`` holds the global ranks laid out in the mesh's shape (JAX's
    ``Mesh.devices``); ``coords`` this rank's coordinate on each axis;
    ``groups`` each axis's :class:`~.collectives.AxisGroup` (None for an
    axis of size 1, which needs no collective); ``device`` this rank's
    device, where :func:`shard_params` puts its shard."""

    axis_names: Tuple[str, ...]
    devices: np.ndarray
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[AxisGroup]]
    device: Optional[torch.device] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def group(self, axis: Optional[str]) -> Optional[AxisGroup]:
        return self.groups.get(axis) if axis else None

    @classmethod
    def abstract(cls, axis_sizes: Dict[str, int],
                 coords: Optional[Dict[str, int]] = None) -> "Mesh":
        """A mesh of the given axes seen from the rank at ``coords``, with no
        process groups: enough for placements and for cutting a rank's
        shard on the host, not for a forward that needs a collective."""
        ranks = np.arange(int(np.prod(list(axis_sizes.values())))).reshape(
            tuple(axis_sizes.values()))
        coords = {name: int((coords or {}).get(name, 0)) for name in axis_sizes}
        rank = int(ranks[tuple(coords[name] for name in axis_sizes)])
        return cls(tuple(axis_sizes), ranks, rank, coords, {name: None for name in axis_sizes})


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_from_ranks(axis_sizes: Dict[str, int], ranks: np.ndarray,
                    device: DeviceLike = None) -> Mesh:
    """A mesh whose axes lay out the global ``ranks`` array (of the axes'
    shape). Every rank must call it alike: it makes one process group for
    each line of ranks along each axis of size > 1, all in one order."""
    world, me = _world()
    names = tuple(axis_sizes)
    where = np.argwhere(ranks == me)
    if len(where) != 1:
        raise ValueError(f"rank {me} is not in the mesh {ranks.tolist()}")
    coords = dict(zip(names, (int(c) for c in where[0])))
    groups: Dict[str, Optional[AxisGroup]] = {}
    for ax, name in enumerate(names):
        size = ranks.shape[ax]
        groups[name] = None
        if size == 1:
            continue
        others = [range(s) for i, s in enumerate(ranks.shape) if i != ax]
        for idx in itertools.product(*others):
            sl = list(idx)
            sl.insert(ax, slice(None))
            line = tuple(int(r) for r in ranks[tuple(sl)])
            g = dist.new_group(list(line))
            if me in line:
                groups[name] = AxisGroup(name, g, size, line.index(me), line)
    if device is None:
        from .distributed import local_device

        device = local_device()
    return Mesh(names, ranks, me, coords, groups,
                None if device is None else torch.device(device))


def make_mesh(axis_sizes: Dict[str, int], device: DeviceLike = None) -> Mesh:
    """A named mesh over all ranks, e.g. ``make_mesh({"dp": 2, "tp": 4})``:
    ranks in row-major order over the axes. Raises ``ValueError("mesh
    needs n ranks, have m")`` where the axes ask for more ranks than the
    run has (and where they cover fewer: every rank takes a place)."""
    world, _ = _world()
    n = int(np.prod(list(axis_sizes.values())))
    if n > world:
        raise ValueError(f"mesh needs {n} ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh covers {n} ranks, have {world}: every rank needs a place")
    return mesh_from_ranks(axis_sizes, np.arange(n).reshape(tuple(axis_sizes.values())),
                           device)


def _tp(mesh: Mesh) -> Optional[str]:
    return "tp" if "tp" in mesh.axis_names else None


def _ep(mesh: Mesh) -> Optional[str]:
    if "ep" in mesh.axis_names:
        return "ep"
    return _tp(mesh)


# ---------------------------------------------------------------------------
# placements (the JAX package's param_pspecs, leaf for leaf)
# ---------------------------------------------------------------------------

def _linear_pspecs(lin: Any, shard_axis: int, axis_name: Optional[str],
                   expert_axis: Optional[str] = None) -> Any:
    """A QuantLinear (or, with ``expert_axis``, ExpertLinears) whose leaves
    are placements. ``shard_axis`` 1: column-parallel (N), 0: row-parallel
    (K and the scale rows)."""
    off = 1 if expert_axis is not None else 0

    def spec_for(arr: Optional[torch.Tensor]) -> Optional[P]:
        if arr is None:
            return None
        dims: List[Optional[str]] = [None] * (arr.ndim - off)
        if axis_name is not None and dims:
            dims[-1 if shard_axis == 1 else 0] = axis_name
        if expert_axis is not None:
            dims = [expert_axis] + dims
        return P(*dims)

    bias = None
    if lin.bias is not None:
        dims = [axis_name if (shard_axis == 1 and axis_name) else None]
        bias = P(*([expert_axis] + dims if expert_axis is not None else dims))
    cls = ExpertLinears if expert_axis is not None else QuantLinear
    return cls(kind=lin.kind, weight=spec_for(lin.weight), scale=spec_for(lin.scale),
               zero_point=spec_for(lin.zero_point), bias=bias, meta=lin.meta)


def param_pspecs(spec: ModelSpec, params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The placement tree of ``params`` (unsharded), leaf for leaf with the
    JAX package's ``param_pspecs``: a :class:`P` (or None) where the params
    hold a tensor."""
    tp, ep = _tp(mesh), _ep(mesh)

    def for_layer(i: int, layer: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"input_layernorm": P(None),
                               "post_attention_layernorm": P(None)}
        if spec.qk_norm:
            out["q_norm"] = P(None)
            out["k_norm"] = P(None)
        if spec.is_mla:
            if spec.q_lora_rank:
                out["q_a_proj"] = _linear_pspecs(layer["q_a_proj"], 1, None)
                out["q_a_layernorm"] = P(None)
                out["q_b_proj"] = _linear_pspecs(layer["q_b_proj"], 1, tp)
            else:
                out["q_proj"] = _linear_pspecs(layer["q_proj"], 1, tp)
            out["kv_a_proj_with_mqa"] = _linear_pspecs(layer["kv_a_proj_with_mqa"], 1, None)
            out["kv_a_layernorm"] = P(None)
            out["kv_b_proj"] = _linear_pspecs(layer["kv_b_proj"], 1, tp)
            if "mla_absorb" in layer:
                out["mla_absorb"] = {"w_uk_t": P(tp, None, None), "w_uv": P(tp, None, None)}
        elif "qkv_proj" in layer:
            out["qkv_proj"] = _linear_pspecs(layer["qkv_proj"], 1, tp)
        else:
            for name in ("q_proj", "k_proj", "v_proj"):
                out[name] = _linear_pspecs(layer[name], 1, tp)
        out["o_proj"] = _linear_pspecs(layer["o_proj"], 0, tp)
        if spec.layer_is_moe(i):
            moe = layer["moe"]
            mout: Dict[str, Any] = {"router": _linear_pspecs(moe["router"], 1, None)}
            if "e_score_correction_bias" in moe:
                mout["e_score_correction_bias"] = P(None)
            if "shared_experts" in moe:
                sh = moe["shared_experts"]
                mout["shared_experts"] = {
                    "gate_proj": _linear_pspecs(sh["gate_proj"], 1, tp),
                    "up_proj": _linear_pspecs(sh["up_proj"], 1, tp),
                    "down_proj": _linear_pspecs(sh["down_proj"], 0, tp)}
            # from one expert's 2-D view, as the JAX package does: the
            # expert axis first, the trailing dimensions left out (replicated)
            for name in ("gate_proj", "up_proj", "gate_up_proj"):
                if name in moe:  # gate_up_proj: the port's fused w8pc stack
                    mout[name] = _linear_pspecs(moe[name].expert(0), 1, None, expert_axis=ep)
            mout["down_proj"] = _linear_pspecs(moe["down_proj"].expert(0), 0, None,
                                               expert_axis=ep)
            out["moe"] = mout
        else:
            mlp = layer["mlp"]
            names = (("gateup_proj", 1), ("down_proj", 0)) if "gateup_proj" in mlp else (
                ("gate_proj", 1), ("up_proj", 1), ("down_proj", 0))
            out["mlp"] = {name: _linear_pspecs(mlp[name], axis, tp) for name, axis in names}
        return out

    return {"embed": P(None, None),
            "layers": [for_layer(i, lyr) for i, lyr in enumerate(params["layers"])],
            "final_norm": P(None),
            "lm_head": None if params.get("lm_head") is None
            else _linear_pspecs(params["lm_head"], 1, tp)}


def activation_pspec(mesh: Mesh, ndim: int = 3) -> P:
    """Batch-split activations: (B, T, D) -> P('dp', None, None). Part of
    the JAX package's API; the port's forward splits batches in
    ``cli/serve.py`` and does not read it."""
    dp = "dp" if "dp" in mesh.axis_names else None
    return P(*([dp] + [None] * (ndim - 1)))


def kv_cache_pspecs(mesh: Mesh) -> Any:
    """The KV cache (B, H_kv, S, hd), head-major: batch over dp, heads over
    tp (an MLA latent cache, head-shared, stays replicated over tp). Part
    of the JAX package's API; the port's caches are made per rank from the
    local spec and do not read it."""
    from ..models.transformer import KVCache

    dp = "dp" if "dp" in mesh.axis_names else None
    tp = _tp(mesh)
    return KVCache(k=P(dp, tp, None, None), v=P(dp, tp, None, None), length=P(),
                   k_scale=None, v_scale=None)


def compatible_pspec(p: P, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Drop the mesh axes a dimension cannot be divided by (a tiny scale
    grid (K/g, N) with K/g < tp): that dimension is replicated."""
    sizes = mesh.shape
    dims: List[Optional[str]] = []
    for i, axis in enumerate(tuple(p) + (None,) * (len(shape) - len(tuple(p)))):
        if axis is None:
            dims.append(None)
            continue
        n = sizes.get(axis, 1)
        dims.append(axis if (i < len(shape) and shape[i] % n == 0) else None)
    return P(*dims)


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------

def _replace_meta(meta, **kv) -> tuple:
    return tuple((k, kv.get(k, v)) for k, v in meta)


def _scale_group(lin: Any, arr: torch.Tensor, axis: str) -> Optional[int]:
    """How many of the weight's rows (axis "k") or columns (axis "n") one
    row or column of ``arr`` (a scale or zero-point grid) covers; None
    where the grid has one row or column for all of them (replicated)."""
    md = lin.meta_dict
    dim = -2 if axis == "k" else -1
    if arr.shape[dim] == 1:
        return None
    if axis == "n":
        return int(md["block_n"]) if md.get("strategy") == "block" else 1
    if md.get("strategy") == "block":
        return int(md["block_k"])
    return int(md["group_size"])


def _take(lin: Any, axis: str, spans: Sequence[Tuple[int, int]]) -> Any:
    """The linear (or expert stack) restricted to the weight's rows (axis
    "k") or columns (axis "n") in ``spans``, concatenated in order; its
    scale, zero-point and bias grids follow. Packed split-half payloads are
    unpacked, sliced and packed again, so the shard's codes are the whole
    weight's, bit for bit."""
    md = lin.meta_dict
    k, n = int(md["k"]), int(md["n"])
    full = k if axis == "k" else n
    dim = -2 if axis == "k" else -1

    def cut(arr: torch.Tensor, unit: int) -> torch.Tensor:
        idx = []
        for a, b in spans:
            if a // unit == (b - 1) // unit:  # inside one group: its row serves the shard
                idx.append(torch.arange(a // unit, a // unit + 1))
            elif a % unit or (b % unit and b != full):
                raise ValueError(f"a {lin.kind} shard [{a}, {b}) of {axis}={full} splits a "
                                 f"group of {unit}")
            else:
                idx.append(torch.arange(a // unit, -(-b // unit)))
        return torch.index_select(arr, arr.ndim + dim, torch.cat(idx).to(arr.device))

    w = lin.weight
    packed = w.dtype == torch.uint8 and lin.kind in ("w4", "nvfp4")
    if packed and axis == "k":
        u = torch.cat([w & 0x0F, w >> 4], dim=-2)[..., :k, :]
        rows = cut(u, 1)
        if rows.shape[-2] % 2:
            raise ValueError(f"a packed {lin.kind} shard needs an even number of rows")
        half = rows.shape[-2] // 2
        weight = (rows[..., :half, :] | (rows[..., half:, :] << 4)).contiguous()
    else:
        weight = cut(w, 1).contiguous()

    def grid(arr: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if arr is None:
            return None
        unit = _scale_group(lin, arr, axis)
        return arr if unit is None else cut(arr, unit).contiguous()

    bias = lin.bias
    if bias is not None and axis == "n":
        bias = cut(bias[..., None, :], 1)[..., 0, :].contiguous()
    size = sum(b - a for a, b in spans)
    meta = _replace_meta(lin.meta, **{axis: size})
    return dataclasses.replace(lin, weight=weight, scale=grid(lin.scale),
                               zero_point=grid(lin.zero_point), bias=bias, meta=meta)


@dataclasses.dataclass
class _Heads:
    """This rank's heads: query heads [q0, q0 + H_l), KV heads
    [kv0, kv0 + KV_l)."""

    H_l: int
    q0: int
    KV_l: int
    kv0: int


def _heads(spec: ModelSpec, tp: int, r: int) -> _Heads:
    H, KV = spec.num_heads, spec.num_kv_heads
    if H % tp:
        raise ValueError(f"tp={tp} does not divide the {H} query heads")
    H_l = H // tp
    if spec.is_mla or KV % tp == 0:
        KV_l = KV // tp if KV % tp == 0 else KV
        return _Heads(H_l, r * H_l, KV_l, r * KV_l if KV % tp == 0 else 0)
    rep = H // KV
    if rep % H_l:
        raise ValueError(f"tp={tp} splits a group of {rep} query heads of one KV head "
                         f"unevenly ({H} heads, {KV} KV heads)")
    # k/v replicated (the compatible rule); this rank reads one KV head
    return _Heads(H_l, r * H_l, 1, (r * H_l) // rep)


def local_spec(spec: ModelSpec, mesh: Mesh) -> ModelSpec:
    """The spec a rank's forward runs with: its query and KV heads."""
    tp = mesh.size(_tp(mesh))
    if tp == 1:
        return spec
    h = _heads(spec, tp, 0)
    return dataclasses.replace(spec, num_heads=h.H_l, num_kv_heads=h.KV_l)


def _split_dim(place: Optional[P], shape: Tuple[int, ...], mesh: Mesh) -> Optional[int]:
    """The dimension of ``shape`` that ``place`` splits over an axis of
    size > 1 once :func:`compatible_pspec` has dropped the axes that do not
    divide it; None where the array is replicated."""
    if place is None:
        return None
    dims = [i for i, axis in enumerate(compatible_pspec(place, shape, mesh))
            if axis is not None and mesh.size(axis) > 1]
    return dims[0] if dims else None


def shard_params(spec: ModelSpec, params: Dict[str, Any], mesh: Mesh,
                 device: DeviceLike = None) -> Tuple[ModelSpec, Dict[str, Any]]:
    """``(local spec, this rank's tree)`` for ``params`` under ``mesh``.

    Each linear's placement comes from :func:`param_pspecs` through
    :func:`compatible_pspec`, read on its logical shape (K, N), or (E, K, N)
    for an expert stack: a linear whose placement splits N is cut by
    columns, one that splits K by rows (a
    :class:`~.collectives.RowParallel`), a stack that splits E keeps its
    experts ``[first, first + E/shards)``, an untied head that splits N
    becomes a :class:`~.collectives.ColumnGather`, and the rest stays
    whole. The cut itself follows the arrays' meaning (the module's notes:
    split-half rows, fused segments, heads). The slices are taken where the
    params lie (the host, for a model loaded there) and only they are moved
    to ``device`` (by default the mesh's). Along axes of size 1 the tree is
    the whole model."""
    dev = resolve_device(device if device is not None else mesh.device)
    tp_name, ep_name = _tp(mesh), _ep(mesh)
    tp, r, tpg = mesh.size(tp_name), mesh.coords.get(tp_name, 0), mesh.group(tp_name)
    ep, e_idx, epg = mesh.size(ep_name), mesh.coords.get(ep_name, 0), mesh.group(ep_name)

    def put(x: Any) -> Any:
        return x.to(dev)

    if tp == 1 and ep == 1:
        from ..models.transformer import tree_to

        return spec, tree_to(params, dev)
    h = _heads(spec, tp, r)
    places = param_pspecs(spec, params, mesh)

    def split(lin: Any, place: Any, n: Optional[int] = None) -> Optional[str]:
        """"k", "n" or None: the logical axis ``place`` cuts ``lin`` on
        (``n``: the width of one segment of a fused layout)."""
        md = lin.meta_dict
        dim = _split_dim(place.weight, (int(md["k"]), n or int(md["n"])), mesh)
        return None if dim is None else "kn"[dim]

    def cols(lin: Any, place: Any, spans, n: Optional[int] = None) -> Any:
        if split(lin, place, n) != "n":
            return put(lin)
        return put(_take(lin, "n", spans))

    def heads(lin: Any, place: Any, spans) -> Any:
        """A projection onto heads: every rank computes only its own."""
        if tp == 1:
            return put(lin)
        if split(lin, place) != "n":
            raise ValueError(f"tp={tp} does not divide the {int(lin.meta_dict['n'])} "
                             "columns of a projection onto heads")
        return put(_take(lin, "n", spans))

    def q_cols(lin: Any, place: Any, width: int) -> Any:
        return heads(lin, place, [(h.q0 * width, (h.q0 + h.H_l) * width)])

    def kv_cols(lin: Any, place: Any, hd: int) -> Any:
        return heads(lin, place, [(h.kv0 * hd, (h.kv0 + h.KV_l) * hd)])

    def even_cols(lin: Any, place: Any) -> Any:
        n = int(lin.meta_dict["n"]) // tp
        return cols(lin, place, [(r * n, (r + 1) * n)])

    def rows(lin: Any, place: Any) -> Any:
        if split(lin, place) != "k":
            return put(lin)
        k = int(lin.meta_dict["k"]) // tp
        shard = _take(dataclasses.replace(lin, bias=None), "k", [(r * k, (r + 1) * k)])
        return RowParallel(put(shard), tpg, None if lin.bias is None else put(lin.bias))

    def experts(el: ExpertLinears, place: Any) -> ExpertLinears:
        md = el.meta_dict
        if _split_dim(place.weight, (el.num_experts, int(md["k"]), int(md["n"])), mesh) != 0:
            return put(el)  # replicated: no sum over ranks
        n = el.num_experts // ep

        def sl(a):
            return None if a is None else put(a[e_idx * n:(e_idx + 1) * n].contiguous())
        return dataclasses.replace(el, weight=sl(el.weight), scale=sl(el.scale),
                                   zero_point=sl(el.zero_point), bias=sl(el.bias),
                                   shards=ep, first=e_idx * n)

    def for_layer(i: int, layer: Dict[str, Any], pl: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in ("input_layernorm", "post_attention_layernorm", "q_norm", "k_norm",
                    "q_a_layernorm", "kv_a_layernorm"):
            if key in layer:
                out[key] = put(layer[key])
        if spec.is_mla:
            dq, dn, dv = spec.qk_head_dim, spec.qk_nope_head_dim, spec.v_head_dim
            if spec.q_lora_rank:
                out["q_a_proj"] = put(layer["q_a_proj"])
                out["q_b_proj"] = q_cols(layer["q_b_proj"], pl["q_b_proj"], dq)
            else:
                out["q_proj"] = q_cols(layer["q_proj"], pl["q_proj"], dq)
            out["kv_a_proj_with_mqa"] = put(layer["kv_a_proj_with_mqa"])
            out["kv_b_proj"] = q_cols(layer["kv_b_proj"], pl["kv_b_proj"], dn + dv)
            if "mla_absorb" in layer:
                absorb = {}
                for key, w in layer["mla_absorb"].items():
                    if _split_dim(pl["mla_absorb"][key], tuple(w.shape), mesh) != 0:
                        raise ValueError(f"tp={tp} does not divide mla_absorb's heads")
                    absorb[key] = put(w[h.q0:h.q0 + h.H_l].contiguous())
                out["mla_absorb"] = absorb
        elif "qkv_proj" in layer:
            H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
            q0, k0 = h.q0 * hd, H * hd + h.kv0 * hd
            v0 = (H + KV) * hd + h.kv0 * hd
            out["qkv_proj"] = heads(layer["qkv_proj"], pl["qkv_proj"], [
                (q0, q0 + h.H_l * hd), (k0, k0 + h.KV_l * hd), (v0, v0 + h.KV_l * hd)])
        else:
            out["q_proj"] = q_cols(layer["q_proj"], pl["q_proj"], spec.head_dim)
            out["k_proj"] = kv_cols(layer["k_proj"], pl["k_proj"], spec.head_dim)
            out["v_proj"] = kv_cols(layer["v_proj"], pl["v_proj"], spec.head_dim)
        out["o_proj"] = rows(layer["o_proj"], pl["o_proj"])
        if spec.layer_is_moe(i):
            moe, pm = layer["moe"], pl["moe"]
            mout: Dict[str, Any] = {"router": put(moe["router"])}
            if "e_score_correction_bias" in moe:
                mout["e_score_correction_bias"] = put(moe["e_score_correction_bias"])
            if "shared_experts" in moe:
                sh, ps = moe["shared_experts"], pm["shared_experts"]
                mout["shared_experts"] = {"gate_proj": even_cols(sh["gate_proj"], ps["gate_proj"]),
                                          "up_proj": even_cols(sh["up_proj"], ps["up_proj"]),
                                          "down_proj": rows(sh["down_proj"], ps["down_proj"])}
            for name in ("gate_proj", "up_proj", "down_proj", "gate_up_proj"):
                if name in moe:
                    mout[name] = experts(moe[name], pm[name])
            if mout["down_proj"].shards > 1:
                mout["expert_group"] = epg
            out["moe"] = mout
        else:
            mlp, pm = layer["mlp"], pl["mlp"]
            if "gateup_proj" in mlp:
                f = int(mlp["gateup_proj"].meta_dict["n"]) // 2
                fl = f // tp
                out["mlp"] = {"gateup_proj": cols(mlp["gateup_proj"], pm["gateup_proj"], [
                    (r * fl, (r + 1) * fl), (f + r * fl, f + (r + 1) * fl)], n=f)}
            else:
                out["mlp"] = {"gate_proj": even_cols(mlp["gate_proj"], pm["gate_proj"]),
                              "up_proj": even_cols(mlp["up_proj"], pm["up_proj"])}
            out["mlp"]["down_proj"] = rows(mlp["down_proj"], pm["down_proj"])
        return out

    head = params.get("lm_head")
    if head is not None:
        orig_n = head.meta_dict.get("orig_n")
        if split(head, places["lm_head"], None if orig_n is None else int(orig_n)) == "n":
            if orig_n is not None:  # a padded head: drop the pad before the split
                head = _take(head, "n", [(0, int(orig_n))])
                head = dataclasses.replace(head, meta=tuple(kv for kv in head.meta
                                                            if kv[0] != "orig_n"))
            head = ColumnGather(even_cols(head, places["lm_head"]), tpg)
        else:
            head = put(head)
    return (local_spec(spec, mesh),
            {"embed": put(params["embed"]),
             "layers": [for_layer(i, lyr, pl) for i, (lyr, pl)
                        in enumerate(zip(params["layers"], places["layers"]))],
             "final_norm": put(params["final_norm"]),
             "lm_head": head})
