"""GPTQ: Hessian-based error-compensating quantization.

Counterpart of ``quantizers_tpu/oneshot/gptq.py``, the reference's
``GPTQModifier`` (``scripts/old_scripts/main_glm4-gptq.py:108-126``: W4A16
g128 asymmetric with ``dampening_frac``; ``configs/recipes/
recipe_gptq_w4a16_g128.yaml``). Design, as in the JAX package:

* Hessians ``H = sum 2 X^T X`` accumulate on the activations' device in
  f32, one ``K x K`` per distinct input (q/k/v share one, gate/up another;
  an expert stack's down_proj gets ``(E, C, C)``), batch by batch, with no
  host synchronization.
* The upper-triangular factor ``U`` of the damped ``H^-1`` (``H^-1 = U^T
  U``) comes from one Cholesky and one triangular solve in f64 on the
  weights' device, rounded to f32 (:func:`_ufactor`: the same U on the
  card and the CPU; the JAX package's is f32), with scipy's f64 LAPACK on
  the host as the fallback (:func:`_ufactor_host`); each distinct Hessian
  is factored once a layer (``ufactor_cache``).
* Group scales are solved up front from the weights (static groups), so
  the elimination is pure snap-and-propagate: blocks of 128 columns, each
  block's serial column loop in K11 (``csrc/gptq_block.cu``, launched on
  operands converted once a solve: :func:`_block_route`; on the CPU
  ``ops/kernels.py:gptq_block``'s plain version), the error carried to the
  later blocks by one f32 matrix product a block.
* ``actorder`` (group or weight) processes the columns by descending
  Hessian diagonal; ``group`` returns ``g_idx`` (``weight_g_idx`` on disk).

Every f32 matrix product here runs with TF32 off (:func:`_f32_matmuls`):
the reference rejects TF32-style precision loss in quantization statistics
(``docs/quantization_tips_and_tricks.md:6-15``).

Like the JAX package, the device linear of an ``actorder: group`` weight is
built with contiguous groups, ignoring ``g_idx`` (ROADMAP queue 3), and an
asymmetric w4 record packs as the JAX package packs it.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.numerics import QuantizedTensor, compute_scale_zp, minmax_along
from ..core.scheme import ActOrder, QuantizationArgs, QuantScheme, QuantType
from ..ops import kernels as K
from .modifiers import LayerCtx, Modifier, SiteResult, build_site_result, expert_weights_enk, weight_nk
from .sites import LinearSite

logger = logging.getLogger(__name__)

#: device factors that failed and were replaced by the host's (each is
#: logged); nothing resets it
host_factor_fallbacks = 0


@contextlib.contextmanager
def _f32_matmuls():
    """Full-f32 matrix products on the card while active (TF32 off, as it is
    by default), whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# core solve
# ---------------------------------------------------------------------------

def _solve_qparams(w: torch.Tensor, args: QuantizationArgs):
    """Per-group (scale, zp) from the current weights, shaped (N, n_groups)
    (a channel strategy's (N, 1) is one group of K), and the group size."""
    g = int(args.group_size) if args.group_size else w.shape[1]
    mn, mx = minmax_along(w, args)  # honors the strategy
    scale, zp = compute_scale_zp(mn, mx, args)
    return scale, zp, g


def _eliminate(block: Callable, W: torch.Tensor, Hinv_u: torch.Tensor, scale: torch.Tensor,
               zp: Optional[torch.Tensor], col_group: torch.Tensor, block_size: int,
               qmin: float, qmax: float, sym: bool) -> torch.Tensor:
    """The blocked elimination with ``block`` for each block's serial part;
    the tail update ``W[:, end:] -= Err @ U[start:end, end:]`` (the JAX
    package's full-width masked product, whose other columns are zero) is
    one f32 matrix product a block."""
    N, K_ = W.shape
    zp = zp if (not sym and zp is not None) else None
    W = W.clone()
    Q = torch.empty_like(W)
    with _f32_matmuls():
        for start in range(0, K_, block_size):
            end = start + block_size
            q, err = block(W[:, start:end], Hinv_u[start:end, start:end], scale, zp,
                           col_group[start:end], qmin, qmax)
            Q[:, start:end] = q
            if end < K_:
                W[:, end:] -= err @ Hinv_u[start:end, end:]
    return Q


def _block_route(W: torch.Tensor, Hinv_u: torch.Tensor, scale: torch.Tensor,
                 zp: Optional[torch.Tensor], col_group: torch.Tensor, block_size: int,
                 sym: bool):
    """The block function of a solve on W's device and the operands it
    reads. On the card: K11's launch with the scales, zero points and
    column groups converted once a solve (``ops/kernels.py:gptq_operands``)
    and the SM count and stream read once, so that a block's launch
    converts and checks nothing of them. Elsewhere ``gptq_block`` as it is
    (on the CPU its plain version)."""
    if W.device.type != "cuda":
        return K.gptq_block, scale, zp, col_group
    if block_size > K.GPTQ_MAX_BLOCK:
        raise K.KernelUnsupported(f"gptq block takes blocks of at most {K.GPTQ_MAX_BLOCK} "
                                  f"columns: {block_size}")
    if Hinv_u.device != W.device:
        raise ValueError("gptq_block: tensors on more than one device")
    scale, zp, col_group = K.gptq_operands(W.device, scale, None if sym else zp, col_group)
    return K.gptq_block_launcher(W.device), scale, zp, col_group


def _gptq_solve(W: torch.Tensor, Hinv_u: torch.Tensor, scale: torch.Tensor,
                zp: Optional[torch.Tensor], col_group: torch.Tensor, *, block_size: int,
                qmin: float, qmax: float, sym: bool) -> torch.Tensor:
    """Blocked GPTQ elimination. W (N, K) f32 with K a multiple of
    ``block_size``, Hinv_u (K, K) the upper-triangular factor of H^-1,
    col_group (K,) int32 maps processing column -> scale group. Returns the
    quantized grid values Q (N, K) f32 (integer levels, before the scales).
    Each block's column loop is K11 (``ops/kernels.py:gptq_block``) on the
    card, its plain version on the CPU (:func:`_block_route`): equal, bit
    for bit, to :func:`gptq_solve_plain` on either device."""
    block, scale, zp, col_group = _block_route(W, Hinv_u, scale, zp, col_group, block_size, sym)
    return _eliminate(block, W, Hinv_u, scale, zp, col_group, block_size, qmin, qmax, sym)


def gptq_solve_plain(W: torch.Tensor, Hinv_u: torch.Tensor, scale: torch.Tensor,
                     zp: Optional[torch.Tensor], col_group: torch.Tensor, *, block_size: int,
                     qmin: float, qmax: float, sym: bool) -> torch.Tensor:
    """:func:`_gptq_solve` with every block's column loop in PyTorch
    (``ops/kernels.py:gptq_block_plain``) on the tensors' own device: the
    JAX package's ``fori_loop`` written as Python loops, the oracle of K11."""
    return _eliminate(K.gptq_block_plain, W, Hinv_u, scale, zp, col_group, block_size, qmin,
                      qmax, sym)


def _ufactor(H: torch.Tensor, dampening_frac: float) -> torch.Tensor:
    """Damped H -> upper-triangular U with H^-1 = U^T U, computed in f64 on
    H's device and rounded to f32, with no host synchronization.

    In f64 so that the factor is the same on every device: the elimination
    given one U lands on the same codes on the card and the CPU, but an f32
    factor carries its library's roundings (an f32 cuSOLVER factor of a
    Qwen3-4B Hessian lay 2.2x farther from the f64 one than f32 LAPACK's,
    and twice as far from it as one f32 ulp of H moves it), and GPTQ
    carries such a difference into codes several steps apart. The JAX
    package factors in f32 (a TPU has no f64).

    The exchange-matrix identity (see :func:`_ufactor_host`): with B = JHJ
    and B = L_b L_b^T, U = J L_b^-1 J is upper and H^-1 = U^T U. One
    Cholesky and one triangular solve against the identity, whole (the
    JAX package solves it in column blocks under ``lax.scan`` to bound a
    TPU's memory; at K 9728 a (K, K) f64 buffer is 757 MB). A matrix that
    is not positive definite gives the identity, as the JAX package's NaN
    test does. H is not modified: the host fallback needs it intact."""
    K_ = H.shape[0]
    eye = torch.eye(K_, dtype=torch.float64, device=H.device)
    B = H.flip(0, 1).double()
    B.diagonal().add_(torch.mean(torch.diagonal(B)) * dampening_frac)
    Lb, info = torch.linalg.cholesky_ex(B)
    del B
    M = torch.linalg.solve_triangular(Lb, eye, upper=False)
    del Lb, eye
    U = M.flip(0, 1).float()
    del M
    bad = (info != 0) | torch.isnan(U).any()
    return torch.where(bad, torch.eye(K_, dtype=torch.float32, device=H.device), U)


def _blas_threads():
    """Raise the BLAS thread limit to all cores for the factor call (an
    OpenBLAS that detects one core from its cgroup would run the K 9728
    factor on one thread); a null context where ``threadpoolctl`` is
    absent."""
    try:
        from threadpoolctl import threadpool_limits

        return threadpool_limits(limits=os.cpu_count())
    except Exception:  # threadpoolctl absent: run with ambient limits
        return contextlib.nullcontext()


def _ufactor_host(H: np.ndarray, dampening_frac: float) -> np.ndarray:
    """Host (LAPACK, f64) version of :func:`_ufactor`: the fallback when the
    device factor fails, and the forced path under ``QTPU_GPTQ_FACTOR=host``.

    Uses the exchange-matrix identity ``U = J chol_lower(J H J)^-1 J`` (J the
    anti-diagonal flip): with B = JHJ and B = L_b L_b^T, H^-1 = J B^-1 J =
    (J L_b^-1 J)^T (J L_b^-1 J), and J L_b^-1 J is upper: exactly the U with
    H^-1 = U^T U that the elimination needs. One Cholesky and one triangular
    inverse. Returns f32."""
    import scipy.linalg as sla

    K_ = H.shape[0]
    Hd = H.astype(np.float64)
    damp = dampening_frac * float(np.mean(np.diag(Hd)))
    Hd[np.arange(K_), np.arange(K_)] += damp
    try:
        with _blas_threads():
            B = np.ascontiguousarray(Hd[::-1, ::-1])
            Lb = sla.cholesky(B, lower=True, check_finite=False)
            M = sla.solve_triangular(Lb, np.eye(K_), lower=True, check_finite=False)
        U = np.ascontiguousarray(M[::-1, ::-1])
    except np.linalg.LinAlgError:
        logger.warning("GPTQ: Hessian factorization failed; identity fallback")
        U = np.eye(K_)
    return U.astype(np.float32)


def _device_factor(H: torch.Tensor, dampening_frac: float) -> torch.Tensor:
    """:func:`_ufactor`, finished before it returns: on the card a
    synchronization inside the caller's ``try``, so that an asynchronous
    CUDA error or an out-of-memory lands there and not at a later read."""
    U = _ufactor(H, dampening_frac)
    if U.is_cuda:
        torch.cuda.synchronize(U.device)
    return U


def gptq_quantize(w_nk: torch.Tensor, H: torch.Tensor, args: QuantizationArgs,
                  block_size: int = 128, dampening_frac: float = 0.01,
                  ufactor_cache: Optional[Dict[Any, torch.Tensor]] = None,
                  cache_key: Any = None) -> Tuple[QuantizedTensor, Optional[torch.Tensor]]:
    """Run GPTQ on one weight, on its device. Returns (QuantizedTensor, g_idx
    or None); g_idx is an int32 CPU tensor.

    ``ufactor_cache`` / ``cache_key``: sites fed by the same activations
    share one Hessian (q/k/v; gate/up; a shared expert-stack H feeds every
    expert), and the U factor depends only on (H, actorder, dampening), so
    callers pass a per-layer cache to factor each distinct Hessian once. A
    device factor that failed is replaced by the host's, counted in
    ``host_factor_fallbacks`` and not cached."""
    global host_factor_fallbacks
    N, K_ = w_nk.shape
    dev = w_nk.device
    W = w_nk.float()
    # H is the caller's accumulator (shared by aliased sites): work on a copy
    H = H.to(device=dev, dtype=torch.float32).clone()

    # dead channels: no activation mass -> pin the diagonal, zero the column
    dead = torch.diagonal(H) == 0
    H.diagonal().add_(dead.float())
    W = torch.where(dead[None, :], torch.zeros((), device=dev), W)

    # activation ordering: process salient columns first.
    #   GROUP:  groups are contiguous in the *permuted* domain; g_idx is
    #           returned so that readers regroup (compressed-tensors schema).
    #   WEIGHT: permuted processing order, groups bound to the original
    #           column index (no g_idx on disk).
    perm = None
    if args.actorder in (ActOrder.GROUP, ActOrder.WEIGHT):
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        W_perm = W[:, perm]
        H = H[perm[:, None], perm[None, :]]
    else:
        W_perm = W

    # the upper-triangular factor U of H^-1 (H^-1 = U^T U): on the device by
    # default, the host's LAPACK as the fallback; QTPU_GPTQ_FACTOR=host
    # forces the host path
    full_key = None if cache_key is None else (cache_key, args.actorder, float(dampening_frac))
    if ufactor_cache is not None and full_key in ufactor_cache:
        U = ufactor_cache[full_key]
    else:
        cache = ufactor_cache is not None and full_key is not None
        if os.environ.get("QTPU_GPTQ_FACTOR", "device") == "device":
            try:
                U = _device_factor(H, float(dampening_frac))
            except RuntimeError as exc:  # CUDA errors, out of memory -> the host's LAPACK
                host_factor_fallbacks += 1
                logger.warning("GPTQ: device U-factor failed at K=%d (%s: %s); "
                               "falling back to host LAPACK", K_, type(exc).__name__, exc)
                U = torch.from_numpy(_ufactor_host(H.cpu().numpy(), float(dampening_frac))).to(dev)
                cache = False
        else:
            U = torch.from_numpy(_ufactor_host(H.cpu().numpy(), float(dampening_frac))).to(dev)
        if cache:
            ufactor_cache[full_key] = U
    del H

    qmin, qmax = args.qrange
    g = int(args.group_size) if args.group_size else K_
    if perm is not None and args.actorder == ActOrder.WEIGHT:
        # scales from the original-order weights; groups = original columns
        scale, zp, _ = _solve_qparams(W, args)
        col_group = perm // g  # processing position -> original group
    else:
        scale, zp, _ = _solve_qparams(W_perm, args)
        col_group = torch.arange(K_, device=dev) // g

    # pad K to a block multiple
    bs = min(block_size, K_)
    pad = (-K_) % bs
    n_groups = scale.shape[1]
    if pad:
        W_perm = F.pad(W_perm, (0, pad))
        U = F.pad(U, (0, pad, 0, pad))
        U.diagonal()[K_:] = 1.0
        scale = F.pad(scale, (0, 1), value=1.0)
        if zp is not None:
            zp = F.pad(zp, (0, 1))
        col_group = torch.cat([col_group, torch.full((pad,), n_groups, device=dev)])

    Q = _gptq_solve(W_perm, U, scale, zp, col_group.to(torch.int32), block_size=bs,
                    qmin=float(qmin), qmax=float(qmax), sym=args.symmetric)
    Q = Q[:, :K_]
    scale = scale[:, :n_groups].contiguous()
    if zp is not None:
        zp = zp[:, :n_groups].contiguous()

    g_idx = None
    if perm is not None:
        inv = torch.argsort(perm)
        Q = Q[:, inv]
        if args.actorder == ActOrder.GROUP:
            # the group of original column j: its position in perm order // g
            g_idx = (inv // g).to(torch.int32).cpu()

    vals = Q.to(torch.int8) if args.type == QuantType.INT else Q
    qt = QuantizedTensor(values=vals, scale=scale, zero_point=None if args.symmetric else zp,
                         global_scale=None, shape=(N, K_))
    return qt, g_idx


# ---------------------------------------------------------------------------
# modifier
# ---------------------------------------------------------------------------

def _hess_accum(H: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """H += 2 X^T X in place, f32 (full-f32 products); padding rows zeroed."""
    x2 = x.float().reshape(-1, x.shape[-1])
    if mask is not None:
        x2 = x2 * (mask.reshape(-1) > 0).float()[:, None]
    with _f32_matmuls():
        H += 2.0 * torch.matmul(x2.t(), x2)
    return H


def _hess_accum_experts(H: torch.Tensor, x: torch.Tensor,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-expert Hessians (E, C, C) += 2 X_e^T X_e for the whole expert
    stack in one batched product (x: (E, N, C)); padding rows zeroed."""
    xf = x.float()
    if mask is not None:
        xf = xf * (mask.reshape(-1) > 0).float()[None, :, None]
    with _f32_matmuls():
        H += 2.0 * torch.bmm(xf.transpose(1, 2), xf)
    return H


class GPTQModifier(Modifier):
    name = "GPTQModifier"
    needs_capture = True

    def begin_layer(self, ctx: LayerCtx, matched) -> Any:
        state = super().begin_layer(ctx, matched)
        state["H"] = {}  # canonical prefix -> (K, K) | (E, C, C) tensor
        state["alias"] = {}  # site prefix -> canonical H key
        state["_seen"] = {}  # (batch_idx, id(x)) -> canonical prefix
        state["_ckey_owner"] = {}  # canonical capture_key -> owner prefix
        return state

    def observe(self, state, site: LinearSite, x_in, mask, capture) -> None:
        super().observe(state, site, x_in, mask, capture)
        # Sites fed by the SAME tensor (q/k/v share the post-norm hidden,
        # gate/up likewise) share one Hessian: accumulate once and alias. The
        # engine's map (``cap["_aliases"]``, by tensor identity) is the
        # authority; the id() path below is for direct observe() calls with
        # no engine capture (unit tests).
        aliases = capture.get("_aliases")
        if aliases is not None:
            ckey = aliases.get(site.capture_key, site.capture_key)
            owner = state["_ckey_owner"].setdefault(ckey, site.prefix)
            state["alias"][site.prefix] = owner
            if owner != site.prefix:
                return
        else:
            xid = (capture.get("_batch_idx", None), id(x_in))
            canon = state["_seen"].get(xid)
            if canon is not None and canon != site.prefix \
                    and state["alias"].get(canon) == canon:
                state["alias"][site.prefix] = canon
                return
            if state["alias"].get(site.prefix, site.prefix) != site.prefix:
                return  # aliased to another site in an earlier batch
            state["_seen"][xid] = site.prefix
            state["alias"][site.prefix] = site.prefix

        if site.is_expert and x_in.ndim == 3:
            # (E, N, C) expert inputs -> stacked per-expert Hessians
            E, N, C = x_in.shape
            masked = mask is not None and mask.numel() == N
            H = state["H"].get(site.prefix)
            if H is None:
                H = torch.zeros((E, C, C), dtype=torch.float32, device=x_in.device)
            state["H"][site.prefix] = _hess_accum_experts(H, x_in, mask if masked else None)
            return
        K_ = x_in.shape[-1]
        rows = x_in.numel() // K_
        masked = mask is not None and mask.numel() == rows
        H = state["H"].get(site.prefix)
        if H is None:
            H = torch.zeros((K_, K_), dtype=torch.float32, device=x_in.device)
        state["H"][site.prefix] = _hess_accum(H, x_in, mask if masked else None)

    def _H_for(self, state, key: str):
        return state["H"].get(state["alias"].get(key, key))

    def compress(self, state, site: LinearSite, group: str, scheme: QuantScheme) -> SiteResult:
        args = scheme.weights
        bs = self.spec.block_size
        damp = self.spec.dampening_frac
        # a per-layer U-factor cache keyed by the canonical (aliased) Hessian
        # owner: q/k/v and gate/up share one H, and a shared expert-stack H
        # feeds every expert; each H is factored once
        ucache = state.setdefault("_ufactor_cache", {})
        canon = state["alias"].get(site.prefix, site.prefix)
        if site.is_expert:
            el = site.get()
            w = expert_weights_enk(el)
            # (E, C, C) stacked per-expert Hessians (down_proj: each expert's
            # activations differ), or (C, C) shared (gate/up: the capture
            # feeds every expert the same pre-routing hidden, so one Hessian
            # is exact for all of them), or None (no calibration batch: the
            # identity, which is RTN)
            Hs = self._H_for(state, site.prefix)
            qts = []
            for e in range(el.num_experts):
                if Hs is None:
                    H = torch.eye(w.shape[-1], dtype=torch.float32, device=w.device)
                    key = ("_eye", w.shape[-1])
                elif Hs.ndim == 3:
                    H, key = Hs[e], (canon, e)
                else:
                    H, key = Hs, (canon, None)
                qt, _ = gptq_quantize(w[e], H, args, bs, damp, ufactor_cache=ucache,
                                      cache_key=key)
                qts.append(qt)
            del w
            res = build_site_result(site, args, group, qt_per_expert=qts,
                                    act_args=scheme.input_activations)
        else:
            H = self._H_for(state, site.prefix)
            w = weight_nk(site.get())
            if H is None:
                logger.warning("GPTQ: no activations for %s; falling back to RTN", site.prefix)
                res = build_site_result(site, args, group, w_nk=w,
                                        act_args=scheme.input_activations)
                return self.finalize_site(state, site, scheme, res)
            qt, g_idx = gptq_quantize(w, H, args, bs, damp, ufactor_cache=ucache,
                                      cache_key=(canon, None))
            del w
            res = build_site_result(site, args, group, qt=qt, g_idx=g_idx,
                                    act_args=scheme.input_activations)
        return self.finalize_site(state, site, scheme, res)
